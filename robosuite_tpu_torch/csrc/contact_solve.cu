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
// so its solve carries none of the equality branches' cost.
template <bool EQ>
__global__ void __launch_bounds__(RS_S_SOLVE * 32) rs_contact_solve_kernel(
    int words, int B, int nv, int K, int ne, int iters, int power_iters, float dt, const float* M, const float* JfT,
    const float* aref, const float* qfrc, const float* qvel, const float* damping, const float* reg3,
    const float* mu, const float* active, float* qvel_out, float* f_out) {
  extern __shared__ __align__(16) float rs_smem[];
  const int warp = threadIdx.x >> 5, b = blockIdx.x * RS_S_SOLVE + warp;
  if (b >= B) return;
  Carver c{rs_smem + (size_t)warp * words, 0};
  float* Msh;
  Solve s;
  carve_k2(nv, K, EQ ? ne : 0, c, Msh, s);
  contact_solve_body(WarpTeam(), s, Msh, b, nv, K, iters, power_iters, dt, M, JfT, aref, qfrc, qvel, damping, reg3,
                     mu, active, qvel_out, f_out);
}

// Shared memory of one K2 block (RS_S_SOLVE scenarios) at nv dofs, K
// contact rows and ne equality rows, in bytes.
extern "C" int rs_contact_solve_smem_bytes(int nv, int K, int ne) {
  return RS_S_SOLVE * solve_words(nv, K, ne) * 4;
}

extern "C" int rs_contact_solve(const float* M, const float* JfT, const float* aref, const float* qfrc,
                                const float* qvel, const float* damping, const float* reg3, const float* mu,
                                const float* active, float* qvel_out, float* f_out, int B, int nv, int K, int ne,
                                int iters, int power_iters, float dt, void* stream) {
  if (nv > RS_MAXV || K > RS_MAXK || ne < 0 || ne > RS_MAXE) return (int)cudaErrorInvalidValue;
  constexpr int S = RS_S_SOLVE;
  const int words = solve_words(nv, K, ne);
  const size_t bytes = (size_t)S * words * 4;
  auto kernel = ne > 0 ? rs_contact_solve_kernel<true> : rs_contact_solve_kernel<false>;
  static size_t opted[2] = {48 * 1024, 48 * 1024};
  if (bytes > opted[ne > 0]) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    opted[ne > 0] = bytes;
  }
  kernel<<<(B + S - 1) / S, 32 * S, bytes, (cudaStream_t)stream>>>(
      words, B, nv, K, ne, iters, power_iters, dt, M, JfT, aref, qfrc, qvel, damping, reg3, mu, active, qvel_out, f_out);
  return (int)cudaGetLastError();
}
