// K1: batched forward products, one warp per scenario.
//
// Replaces robosuite_tpu/ops/pallas_forward.py _pallas_forward (body
// forward_lane_body). What bounds it on this card: neither bytes (about
// 9.6 KB in and out per scenario, the larger of its two bounds) nor
// operations (about 30 kFLOP per scenario) but latency: the FK tree walk
// is a serial chain of 26 dependent quaternion products on one lane, and
// the later per-body / per-dof stages are short. The design runs each
// scenario on one warp (forward.cuh forward_team, the same code K3 runs),
// S scenarios a block, with its arrays carved from the model's own sizes
// in dynamic shared memory (at most about 10 KB a scenario at the
// compile-time maxima, so four fit the default 48 KB), and writes each
// output once.
#include "forward.cuh"

// Shared memory of one K1 scenario, in words, rounded to 4.
static int forward_words(const RsTables& T) {
  Carver c{nullptr, 0};
  Fwd s;
  carve_fwd(T, c, s);
  carve_rnea(T, c, s);
  return (c.w + 3) / 4 * 4;
}

__global__ void __launch_bounds__(RS_S_FORWARD * 32) rs_forward_kernel(
    const RsTables* __restrict__ T, int words, int B, const float* qpos, const float* qvel, const float* mass,
    const float* inertia, const float* gravity, const float* armature, float* xpos, float* xquat, float* xmat,
    float* gxpos, float* gxmat, float* sxpos, float* sxmat, float* sdof_ang, float* sdof_lin, float* M, float* bias,
    float* xipos, float* ximat) {
  extern __shared__ __align__(16) float rs_smem[];
  const int warp = threadIdx.x >> 5, b = blockIdx.x * RS_S_FORWARD + warp;
  if (b >= B) return;
  Carver c{rs_smem + (size_t)warp * words, 0};
  Fwd s;
  carve_fwd(*T, c, s);
  carve_rnea(*T, c, s);
  forward_body(WarpTeam(), *T, s, b, qpos, qvel, mass, inertia, gravity, armature, xpos, xquat, xmat, gxpos, gxmat,
               sxpos, sxmat, sdof_ang, sdof_lin, M, bias, xipos, ximat);
}

extern "C" int rs_forward(const void* T, const void* T_host, const float* qpos, const float* qvel,
                          const float* mass, const float* inertia, const float* gravity, const float* armature,
                          float* xpos, float* xquat, float* xmat, float* gxpos, float* gxmat, float* sxpos,
                          float* sxmat, float* sdof_ang, float* sdof_lin, float* M, float* bias, float* xipos,
                          float* ximat, int B, void* stream) {
  constexpr int S = RS_S_FORWARD;
  const int words = forward_words(*(const RsTables*)T_host);
  rs_forward_kernel<<<(B + S - 1) / S, 32 * S, (size_t)S * words * 4, (cudaStream_t)stream>>>(
      (const RsTables*)T, words, B, qpos, qvel, mass, inertia, gravity, armature, xpos, xquat, xmat, gxpos, gxmat,
      sxpos, sxmat, sdof_ang, sdof_lin, M, bias, xipos, ximat);
  return (int)cudaGetLastError();
}

extern "C" int rs_tables_size() { return (int)sizeof(RsTables); }
