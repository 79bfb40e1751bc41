// K4: batched pose-only forward kinematics, RS_S_FK scenarios a block, one
// thread each.
//
// Replaces robosuite_tpu/ops/pallas_fk.py make_fk_kernel (body xpos and
// xquat from qpos); its plain version is ops/fk.py fk_pose_plain. What
// bounds it on this card: the walk's latency (a serial chain of quaternion
// products per scenario), hidden as far as the scenarios in flight allow;
// its bytes (Lift: 64 B in, 728 B out a scenario, ~4 kFLOP) bound a third
// of its time at the iLQR's 32768. A scenario keeps one thread; what the
// design changes is where its arrays live and how the block moves its
// bytes:
//   - the block loads its contiguous span of qpos 16 bytes a thread,
//     consecutive threads on consecutive words, transposed into shared
//     memory (forward.cuh span_rows);
//   - each thread's joint terms and poses live in shared memory laid out
//     [row][scenario] (row stride S + 1), so a warp's accesses are
//     consecutive words and free of bank conflicts; no array is in local
//     memory (the poses are indexed by the runtime parent, so registers
//     cannot hold them);
//   - the block stages the walk's rows of K1's model image (forward.cuh
//     carve_tab) in shared memory once, which every thread reads by
//     broadcast; the walk is K1's (forward.cuh joint_terms and fk_walk), so
//     K4, K1 and K3's aux tail share one composition;
//   - the block stores its contiguous xpos and xquat spans the same way
//     (fk_block).
// xpos and xquat are one allocation: xquat starts 4-word aligned after
// xpos's B * nb * 3 words.
#include "forward.cuh"

__global__ void __launch_bounds__(RS_S_FK) rs_fk_kernel(const RsTables* __restrict__ T, const float* __restrict__ tab,
                                                      const float* qpos, float* out, int B) {
  extern __shared__ __align__(16) float rs_smem[];
  const size_t b0 = (size_t)blockIdx.x * RS_S_FK;
  const int nS = min(RS_S_FK, B - (int)b0);
  const size_t nxp = (size_t)B * 3 * T->nbody;
  fk_block(BlockTeam(), *T, tab, rs_smem, RS_S_FK, b0, nS, qpos, out, out + (nxp + 3) / 4 * 4);
}

// Bytes of shared memory a K4 block takes for the host copy of a table.
extern "C" int rs_fk_smem_bytes(const void* T_host) {
  return 4 * fk_block_words(*(const RsTables*)T_host, RS_S_FK);
}

// K4 on B scenarios of qpos (B, nq) into out (xpos, then xquat); tab is
// the model image (forward.cu rs_forward_tab) on the device. -> the CUDA
// error.
extern "C" int rs_fk(const void* T, const void* T_host, const float* tab, const float* qpos, float* out, int B,
                     void* stream) {
  static int opted = 48 * 1024;
  const int bytes = rs_fk_smem_bytes(T_host);
  if (bytes > opted) {
    cudaError_t err = cudaFuncSetAttribute(rs_fk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    opted = bytes;
  }
  rs_fk_kernel<<<(B + RS_S_FK - 1) / RS_S_FK, RS_S_FK, bytes, (cudaStream_t)stream>>>((const RsTables*)T, tab,
                                                                                      qpos, out, B);
  return (int)cudaGetLastError();
}

#ifdef RS_STAGE_CLOCKS
// The diagnostic build's stage clocks (common.cuh RS_STAMP) of the last
// K4 launch into out (RS_NSTAGES values, host memory), then zeroed.
extern "C" int rs_fk_stage_clocks(long long* out) {
  static const long long zero[RS_NSTAGES] = {};
  if (cudaError_t err = cudaMemcpyFromSymbol(out, rs_stage_clock, sizeof(zero))) return (int)err;
  return (int)cudaMemcpyToSymbol(rs_stage_clock, zero, sizeof(zero));
}
#endif
