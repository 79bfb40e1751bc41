// K3: the fused physics substep, one thread block per scenario, and its
// emit_aux variant (the same body plus the post-step aux tail).
//
// Replaces robosuite_tpu/ops/pallas_substep.py _pallas_substep (kernel
// _make_substep_kernel, OSC and JOINT_POSITION branches, with and without
// emit_aux); the arm's torque law is chosen per model by the table's
// ctrl_type. What bounds it on this card: latency and operations, not
// bytes. Per scenario it reads about 0.7 KB and writes about 0.9 KB (the
// aux variant about 1.2 KB more), and computes the forward products, the
// narrowphase pairs (18 on Lift, 26 on Stack), the contact rows (66 / 96;
// 36 / 52 on a 2-point planning model) and the cone QP (about 0.7 MFLOP
// at 30 iterations on Lift). The design keeps every intermediate of the
// substep in shared memory, so device memory sees only the substep's
// inputs and outputs; the serial parts (tree walk, torque law, the
// Cholesky solves) run on one thread, which is what a later persistent
// 25-substep version with warp-level factorisations would attack. The aux
// tail adds one more serial tree walk and one narrowphase pass (one thread
// per pair) and no shared memory.
//
// SubstepShared is sized by the compile-time maxima (about 57 KB at nv 24,
// 96 rows), above the 48 KB a block may hold statically, so it lives in
// dynamic shared memory, opted in once per instantiation with
// cudaFuncAttributeMaxDynamicSharedMemorySize.
#include "substep.cuh"

template <bool AUX>
__global__ void __launch_bounds__(RS_THREADS) rs_substep_kernel(
    const RsTables* __restrict__ T, const float* qpos, const float* qvel, const float* mass, const float* inertia,
    const float* gravity, const float* armature, const float* goal, const float* gains, const float* grip,
    float* qpos_out, float* qvel_out, float* f_out, float* sxpos, float* sxmat, float* bxpos, float* pdist) {
  extern __shared__ __align__(16) unsigned char rs_smem[];
  SubstepShared& sh = *reinterpret_cast<SubstepShared*>(rs_smem);
  substep_body<AUX>(*T, sh, blockIdx.x, qpos, qvel, mass, inertia, gravity, armature, goal, gains, grip, qpos_out,
                    qvel_out, f_out, sxpos, sxmat, bxpos, pdist);
}

// The dynamic shared-memory opt-in of one instantiation, made at its first
// launch; -> the CUDA error it returned.
template <bool AUX>
static cudaError_t smem_opt_in() {
  static const cudaError_t err = cudaFuncSetAttribute(
      rs_substep_kernel<AUX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(SubstepShared));
  return err;
}

extern "C" int rs_substep(const void* T, const float* qpos, const float* qvel, const float* mass,
                          const float* inertia, const float* gravity, const float* armature, const float* goal,
                          const float* gains, const float* grip, float* qpos_out, float* qvel_out, float* f_out,
                          int B, void* stream) {
  if (cudaError_t err = smem_opt_in<false>()) return (int)err;
  rs_substep_kernel<false><<<B, RS_THREADS, sizeof(SubstepShared), (cudaStream_t)stream>>>(
      (const RsTables*)T, qpos, qvel, mass, inertia, gravity, armature, goal, gains, grip, qpos_out, qvel_out,
      f_out, nullptr, nullptr, nullptr, nullptr);
  return (int)cudaGetLastError();
}

extern "C" int rs_substep_aux(const void* T, const float* qpos, const float* qvel, const float* mass,
                              const float* inertia, const float* gravity, const float* armature, const float* goal,
                              const float* gains, const float* grip, float* qpos_out, float* qvel_out, float* f_out,
                              float* sxpos, float* sxmat, float* bxpos, float* pdist, int B, void* stream) {
  if (cudaError_t err = smem_opt_in<true>()) return (int)err;
  rs_substep_kernel<true><<<B, RS_THREADS, sizeof(SubstepShared), (cudaStream_t)stream>>>(
      (const RsTables*)T, qpos, qvel, mass, inertia, gravity, armature, goal, gains, grip, qpos_out, qvel_out,
      f_out, sxpos, sxmat, bxpos, pdist);
  return (int)cudaGetLastError();
}
