// K4: batched pose-only forward kinematics, one thread per scenario.
//
// Replaces robosuite_tpu/ops/pallas_fk.py make_fk_kernel (body xpos and
// xquat from qpos); its plain version is ops/fk.py fk_pose_plain. What
// bounds it on this card: neither bytes (64 B in, 728 B out per scenario
// for the Lift world) nor operations (about 4 kFLOP per scenario) but the
// walk itself, a serial chain of 26 dependent quaternion products per
// scenario. The design runs one scenario per thread (the tree walk is
// serial anyway, so a thread loses nothing to it), keeps the poses in
// that thread's local arrays, and masks the ragged last block, so any B
// launches. Its writes are strided per thread (not coalesced); a layout
// that stages the outputs through shared memory is later work.
#include "forward.cuh"

#define RS_FK_THREADS 128

__global__ void __launch_bounds__(RS_FK_THREADS) rs_fk_kernel(const RsTables* __restrict__ T, const float* qpos,
                                                             float* xpos, float* xquat, int B) {
  size_t b = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= (size_t)B) return;
  fk_pose_one(*T, b, qpos, xpos, xquat);
}

extern "C" int rs_fk(const void* T, const float* qpos, float* xpos, float* xquat, int B, void* stream) {
  int blocks = (B + RS_FK_THREADS - 1) / RS_FK_THREADS;
  rs_fk_kernel<<<blocks, RS_FK_THREADS, 0, (cudaStream_t)stream>>>((const RsTables*)T, qpos, xpos, xquat, B);
  return (int)cudaGetLastError();
}
