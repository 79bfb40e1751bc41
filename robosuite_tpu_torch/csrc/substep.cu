// K3: the fused physics substep, one thread block per scenario, and its
// emit_aux variant (the same body plus the post-step aux tail).
//
// Replaces robosuite_tpu/ops/pallas_substep.py _pallas_substep (kernel
// _make_substep_kernel, OSC branch, with and without emit_aux). What bounds
// it on this card: latency and operations, not bytes. Per scenario it reads
// about 0.7 KB and writes about 0.9 KB (the aux variant about 1.2 KB more),
// and computes the forward products, 18 narrowphase pairs, 66 contact rows
// (36 on a 2-point planning model) and the cone QP (about 0.7 MFLOP at 30
// iterations). The design keeps every intermediate of the substep in shared
// memory (about 35 KB), so device memory sees only the substep's inputs and
// outputs; the serial parts (tree walk, OSC law, the Cholesky solves) run
// on one thread, which is what a later persistent 25-substep version with
// warp-level factorisations would attack. The aux tail adds one more serial
// tree walk and one narrowphase pass (one thread per pair) and no shared
// memory.
#include "substep.cuh"

template <bool AUX>
__global__ void __launch_bounds__(RS_THREADS) rs_substep_kernel(
    const RsTables* __restrict__ T, const float* qpos, const float* qvel, const float* mass, const float* inertia,
    const float* gravity, const float* armature, const float* goal, const float* gains, const float* grip,
    float* qpos_out, float* qvel_out, float* f_out, float* sxpos, float* sxmat, float* bxpos, float* pdist) {
  __shared__ SubstepShared sh;
  substep_body<AUX>(*T, sh, blockIdx.x, qpos, qvel, mass, inertia, gravity, armature, goal, gains, grip, qpos_out,
                    qvel_out, f_out, sxpos, sxmat, bxpos, pdist);
}

extern "C" int rs_substep(const void* T, const float* qpos, const float* qvel, const float* mass,
                          const float* inertia, const float* gravity, const float* armature, const float* goal,
                          const float* gains, const float* grip, float* qpos_out, float* qvel_out, float* f_out,
                          int B, void* stream) {
  rs_substep_kernel<false><<<B, RS_THREADS, 0, (cudaStream_t)stream>>>(
      (const RsTables*)T, qpos, qvel, mass, inertia, gravity, armature, goal, gains, grip, qpos_out, qvel_out,
      f_out, nullptr, nullptr, nullptr, nullptr);
  return (int)cudaGetLastError();
}

extern "C" int rs_substep_aux(const void* T, const float* qpos, const float* qvel, const float* mass,
                              const float* inertia, const float* gravity, const float* armature, const float* goal,
                              const float* gains, const float* grip, float* qpos_out, float* qvel_out, float* f_out,
                              float* sxpos, float* sxmat, float* bxpos, float* pdist, int B, void* stream) {
  rs_substep_kernel<true><<<B, RS_THREADS, 0, (cudaStream_t)stream>>>(
      (const RsTables*)T, qpos, qvel, mass, inertia, gravity, armature, goal, gains, grip, qpos_out, qvel_out,
      f_out, sxpos, sxmat, bxpos, pdist);
  return (int)cudaGetLastError();
}
