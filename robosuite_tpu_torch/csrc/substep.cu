// K3: the fused physics substep, one warp per scenario, and its emit_aux
// variant (the same body plus the post-step aux tail).
//
// Replaces robosuite_tpu/ops/pallas_substep.py _pallas_substep (kernel
// _make_substep_kernel, OSC and JOINT_POSITION branches, with and without
// emit_aux); the arm's torque law is chosen per model by the table's
// ctrl_type. What bounds it on this card: latency, not bytes or
// operations. Per scenario it reads about 0.7 KB and writes about 0.9 KB
// (the aux variant about 1.2 KB more), and computes the forward products,
// the narrowphase (330 candidates on Lift, 490 on Stack), the contact rows
// (66 / 96; 36 on Lift's 2-point planning model) and the cone QP on the
// few active rows, a chain of dependent stages.
//
// The design: a scenario is one warp (common.cuh WarpTeam), RS_S_SUBSTEP
// scenarios a block (one: the most scenarios per SM), so stages
// synchronise with __syncwarp and reduce with shuffles, never at a block
// barrier. Every stage spreads over the lanes but the tree walk (each body
// needs its parent's pose): the Cholesky factorisations and solves, the
// OSC law's products and inverses (double), the narrowphase over (pair,
// candidate), the rows, and the solve on the compacted active rows
// (contact_solve.cuh). Each scenario's shared memory is carved from the
// model's own sizes (substep.cuh carve_substep; 26.4 KB on Lift, 19.7 KB on
// Lift's 2-point planning model, 45.2 KB on Stack), so the SM holds as many
// scenarios as their sizes allow (8, 11 and 5); the opt-in for dynamic
// shared memory is raised to the largest carve launched. The launch bounds
// keep registers to what 12 warps an SM can hold (168), a little more than
// the smallest carve's 11 scenarios.
//
// What this kernel does not use, and why. Tensor cores (wgmma, mma.sync):
// each scenario's operator is nv x ntot <= 24 x 288 in float32, the APGD
// matvecs are sequential, and TF32 would cost the digits the tolerances
// hold. TMA and cp.async: a scenario reads about 0.7 KB and writes about
// 0.9 KB, so there is no transfer to hide. The card's lever here is latency
// hiding: more independent scenarios per SM and no idle lanes.
#include "substep.cuh"

template <bool AUX>
__global__ void __launch_bounds__(RS_S_SUBSTEP * 32, 12 / RS_S_SUBSTEP) rs_substep_kernel(
    const RsTables* __restrict__ T, int words, int B, const float* qpos, const float* qvel, const float* mass,
    const float* inertia, const float* gravity, const float* armature, const float* goal, const float* gains,
    const float* grip, float* qpos_out, float* qvel_out, float* f_out, float* sxpos, float* sxmat, float* bxpos,
    float* pdist) {
  extern __shared__ __align__(16) float rs_smem[];
  const int warp = threadIdx.x >> 5, b = blockIdx.x * RS_S_SUBSTEP + warp;
  if (b >= B) return;
  Sub sh;
  carve_substep(*T, rs_smem + (size_t)warp * words, sh);
  substep_body<AUX>(WarpTeam(), *T, sh, b, qpos, qvel, mass, inertia, gravity, armature, goal, gains, grip,
                    qpos_out, qvel_out, f_out, sxpos, sxmat, bxpos, pdist);
}

// Raise an instantiation's dynamic shared-memory opt-in to `bytes` when it
// is the largest yet; -> the CUDA error.
template <bool AUX>
static cudaError_t smem_opt_in(size_t bytes) {
  static size_t opted = 48 * 1024;
  if (bytes <= opted) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(rs_substep_kernel<AUX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err == cudaSuccess) opted = bytes;
  return err;
}

// Shared memory of one scenario of the fused substep for the host copy of
// a table, in bytes.
extern "C" int rs_substep_smem_bytes(const void* T_host) {
  Sub sh;
  return 4 * carve_substep(*(const RsTables*)T_host, nullptr, sh);
}

// Scenarios resident per SM at this table's carve (negative: the CUDA
// error).
extern "C" int rs_substep_resident(const void* T_host, int aux) {
  constexpr int S = RS_S_SUBSTEP;
  size_t bytes = (size_t)S * rs_substep_smem_bytes(T_host);
  int blocks = 0;
  cudaError_t err = aux ? smem_opt_in<true>(bytes) : smem_opt_in<false>(bytes);
  if (err == cudaSuccess)
    err = aux ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, rs_substep_kernel<true>, 32 * S, bytes)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, rs_substep_kernel<false>, 32 * S, bytes);
  return err == cudaSuccess ? blocks * S : -(int)err;
}

template <bool AUX>
static int launch(const void* T, const void* T_host, const float* qpos, const float* qvel, const float* mass,
                  const float* inertia, const float* gravity, const float* armature, const float* goal,
                  const float* gains, const float* grip, float* qpos_out, float* qvel_out, float* f_out,
                  float* sxpos, float* sxmat, float* bxpos, float* pdist, int B, void* stream) {
  constexpr int S = RS_S_SUBSTEP;
  const int words = rs_substep_smem_bytes(T_host) / 4;
  const size_t bytes = (size_t)S * words * 4;
  if (cudaError_t err = smem_opt_in<AUX>(bytes)) return (int)err;
  rs_substep_kernel<AUX><<<(B + S - 1) / S, 32 * S, bytes, (cudaStream_t)stream>>>(
      (const RsTables*)T, words, B, qpos, qvel, mass, inertia, gravity, armature, goal, gains, grip, qpos_out,
      qvel_out, f_out, sxpos, sxmat, bxpos, pdist);
  return (int)cudaGetLastError();
}

extern "C" int rs_substep(const void* T, const void* T_host, const float* qpos, const float* qvel,
                          const float* mass, const float* inertia, const float* gravity, const float* armature,
                          const float* goal, const float* gains, const float* grip, float* qpos_out,
                          float* qvel_out, float* f_out, int B, void* stream) {
  return launch<false>(T, T_host, qpos, qvel, mass, inertia, gravity, armature, goal, gains, grip, qpos_out,
                       qvel_out, f_out, nullptr, nullptr, nullptr, nullptr, B, stream);
}

extern "C" int rs_substep_aux(const void* T, const void* T_host, const float* qpos, const float* qvel,
                              const float* mass, const float* inertia, const float* gravity, const float* armature,
                              const float* goal, const float* gains, const float* grip, float* qpos_out,
                              float* qvel_out, float* f_out, float* sxpos, float* sxmat, float* bxpos, float* pdist,
                              int B, void* stream) {
  return launch<true>(T, T_host, qpos, qvel, mass, inertia, gravity, armature, goal, gains, grip, qpos_out,
                      qvel_out, f_out, sxpos, sxmat, bxpos, pdist, B, stream);
}

#ifdef RS_STAGE_CLOCKS
// The diagnostic build's stage clocks (common.cuh RS_STAMP) into out
// (RS_NSTAGES values, host memory), then zeroed; -> the CUDA error.
extern "C" int rs_stage_clocks(long long* out) {
  static const long long zero[RS_NSTAGES] = {};
  if (cudaError_t err = cudaMemcpyFromSymbol(out, rs_stage_clock, sizeof(zero))) return (int)err;
  return (int)cudaMemcpyToSymbol(rs_stage_clock, zero, sizeof(zero));
}
#endif
