// K2: batched constrained velocity update (smooth solve + cone QP by APGD
// + implicit-damping solve), one warp per scenario.
//
// Replaces robosuite_tpu/ops/pallas_contact.py _pallas_solver (body
// constrained_vel_lanes). What bounds it on this card: the latency of its
// dependent stages, not bytes or operations. The operands are read once
// (about 15 KB per scenario at nv = 15, 198 rows), and the 41 products
// with the whitened operator touch only the few active rows' columns. The
// design runs each scenario on one warp (contact_solve.cuh
// contact_solve_team, the same code K3 runs), S scenarios a block, keeps
// M, Y and all row vectors in the scenario's dynamic shared memory, sized
// by nv and the rows, for the whole solve (no device-memory traffic
// between iterations).
#include "contact_solve.cuh"

// Shared memory of one K2 scenario, in words, rounded to 4.
static int solve_words(int nv, int K, int ne) {
  Carver c{nullptr, 0};
  float* M;
  Solve s;
  carve_k2(nv, K, ne, c, M, s);
  return (c.w + 3) / 4 * 4;
}

// EQ false: a world with no equality row, ne fixed at 0 at compile time,
// so its solve carries none of the equality branches' cost. S scenarios a
// block: RS_S_SOLVE, or RS_S_SOLVE_WIDE where that block would not fit.
template <bool EQ, int S>
__global__ void __launch_bounds__(S * 32) rs_contact_solve_kernel(
    int words, int B, int nv, int K, int ne, int iters, int power_iters, float dt, const float* M, const float* JfT,
    const float* aref, const float* qfrc, const float* qvel, const float* damping, const float* reg3,
    const float* mu, const float* active, float* qvel_out, float* f_out) {
  extern __shared__ __align__(16) float rs_smem[];
  const int warp = threadIdx.x >> 5, b = blockIdx.x * S + warp;
  if (b >= B) return;
  Carver c{rs_smem + (size_t)warp * words, 0};
  float* Msh;
  Solve s;
  carve_k2(nv, K, EQ ? ne : 0, c, Msh, s);
  contact_solve_body(WarpTeam(), s, Msh, b, nv, K, iters, power_iters, dt, M, JfT, aref, qfrc, qvel, damping, reg3,
                     mu, active, qvel_out, f_out);
}

// The scenarios a K2 block holds at nv dofs, K contact rows and ne
// equality rows.
static int solve_scenarios(int nv, int K, int ne) {
  return (size_t)RS_S_SOLVE * solve_words(nv, K, ne) * 4 <= (size_t)rs_smem_optin() ? RS_S_SOLVE : RS_S_SOLVE_WIDE;
}

// Shared memory of one K2 block (the scenarios solve_scenarios gives) at
// nv dofs, K contact rows and ne equality rows, in bytes.
extern "C" int rs_contact_solve_smem_bytes(int nv, int K, int ne) {
  return solve_scenarios(nv, K, ne) * solve_words(nv, K, ne) * 4;
}

// The scenarios a K2 block holds at nv, K and ne.
extern "C" int rs_contact_solve_scenarios(int nv, int K, int ne) { return solve_scenarios(nv, K, ne); }

template <bool EQ, int S>
static int launch_k2(int words, size_t bytes, cudaStream_t stream, int B, int nv, int K, int ne, int iters,
                     int power_iters, float dt, const float* M, const float* JfT, const float* aref,
                     const float* qfrc, const float* qvel, const float* damping, const float* reg3, const float* mu,
                     const float* active, float* qvel_out, float* f_out) {
  static size_t opted = 48 * 1024;
  if (bytes > opted) {
    cudaError_t err =
        cudaFuncSetAttribute(rs_contact_solve_kernel<EQ, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    opted = bytes;
  }
  rs_contact_solve_kernel<EQ, S><<<(B + S - 1) / S, 32 * S, bytes, stream>>>(
      words, B, nv, K, ne, iters, power_iters, dt, M, JfT, aref, qfrc, qvel, damping, reg3, mu, active, qvel_out, f_out);
  return (int)cudaGetLastError();
}

// K2 on B scenarios. -> the CUDA error (cudaErrorInvalidValue above the
// maxima, or where even one scenario's carve exceeds the opt-in limit).
extern "C" int rs_contact_solve(const float* M, const float* JfT, const float* aref, const float* qfrc,
                                const float* qvel, const float* damping, const float* reg3, const float* mu,
                                const float* active, float* qvel_out, float* f_out, int B, int nv, int K, int ne,
                                int iters, int power_iters, float dt, void* stream) {
  if (nv > RS_MAXV || K > RS_MAXK || ne < 0 || ne > RS_MAXE) return (int)cudaErrorInvalidValue;
  const int words = solve_words(nv, K, ne), S = solve_scenarios(nv, K, ne);
  const size_t bytes = (size_t)S * words * 4;
  if (bytes > (size_t)rs_smem_optin()) return (int)cudaErrorInvalidValue;
  auto launch = S == RS_S_SOLVE ? (ne > 0 ? launch_k2<true, RS_S_SOLVE> : launch_k2<false, RS_S_SOLVE>)
                                : (ne > 0 ? launch_k2<true, RS_S_SOLVE_WIDE> : launch_k2<false, RS_S_SOLVE_WIDE>);
  return launch(words, bytes, (cudaStream_t)stream, B, nv, K, ne, iters, power_iters, dt, M, JfT, aref, qfrc, qvel,
                damping, reg3, mu, active, qvel_out, f_out);
}
