// K1: batched forward products, RS_S_FORWARD scenarios a block (or
// RS_S_FORWARD_WIDE on a world too wide for that block), one warp each.
//
// Replaces robosuite_tpu/ops/pallas_forward.py _pallas_forward (body
// forward_lane_body). What bounds it on this card: latency. Its work is
// small (Lift: 9.1 KB written and 0.1 KB read, ~30 kFLOP a scenario, half
// in float64), so at the env's and the iLQR's widths one scenario's chain
// of stages is the time, and at the forward-difference sweep's 335,872
// scenarios that chain over the scenarios an SM holds (its bytes bound is
// a fifth of its time there). The design shortens the chain (the serial
// tree walk, CRBA, RNEA) and moves the bytes in whole lines:
//   - the block stages the model rows the pass reads (a compact image of
//     the table, one span copy, forward.cuh carve_tab) in shared memory, so
//     the walk and the pair loops wait on shared loads, not on chains of
//     dependent global ones;
//   - the walk's parent-independent joint terms come off the chain, one
//     joint a lane; the chain keeps the quaternion products alone, a
//     parent's pose in registers down a chain (forward.cuh fk_walk);
//   - CRBA's per-pair terms spread over the (body, dof) pairs with anc != 0,
//     one a lane, summed per dof in the list's fixed order; RNEA runs over
//     each body's or dof's run of the pair list;
//   - the block's scenarios are carved region by region (carve_k1), so each
//     input and output is one contiguous span for the block, loaded and
//     stored 16 bytes a thread by consecutive threads; the geom and site
//     poses are staged there too;
//   - the 13 outputs are one allocation (the launcher derives the offsets,
//     k1_offset), and the inertial leaves may have batch stride 0 (the
//     model's own leaves, expanded without a copy).
#include "forward.cuh"

template <int S>
__global__ void __launch_bounds__(S * 32)
    rs_forward_kernel(const RsTables* __restrict__ T, const float* __restrict__ tab, int B, K1Io io) {
  extern __shared__ __align__(16) float rs_smem[];
  const size_t b0 = (size_t)blockIdx.x * S;
  const int nS = min(S, B - (int)b0), team = threadIdx.x / 32;
  const BlockTeam bk{};
  FwdTab F;
  Fwd f0, f;
  Frames fr0, fr;
  carve_k1(*T, rs_smem, S, 0, F, f0, fr0);
  carve_k1(*T, rs_smem, S, team, F, f, fr);
  const int tw = (int)(f0.q - rs_smem);  // the image's words
  RS_STAMP(0);
  load_rows(bk, rs_smem, tw, tab, tw, tw, 1);
  k1_load(bk, F, f0, b0, nS, io);
  __syncthreads();
  RS_STAMP(1);
  const WarpTeam tm{};
  if (team < nS) forward_team(tm, F, f);
  __syncthreads();  // the frames take the place of every scenario's scratch
  if (team < nS) frames_team(tm, F, f, fr);
  RS_STAMP(6);
  __syncthreads();
  k1_store(bk, F, f0, fr0, b0, nS, (size_t)B, io.out);
  RS_STAMP(7);
}

// The scenarios a K1 block of this table holds, and that block's bytes.
static int k1_block(const RsTables& T, int* bytes) {
  FwdTab F;
  Fwd f;
  Frames fr;
  int S = RS_S_FORWARD;
  *bytes = 4 * carve_k1(T, nullptr, S, 0, F, f, fr);
  if (*bytes > rs_smem_optin()) {
    S = RS_S_FORWARD_WIDE;
    *bytes = 4 * carve_k1(T, nullptr, S, 0, F, f, fr);
  }
  return S;
}

// Bytes of shared memory a K1 block takes for the host copy of a table
// (the block the launch picks).
extern "C" int rs_forward_smem_bytes(const void* T_host) {
  int bytes;
  k1_block(*(const RsTables*)T_host, &bytes);
  return bytes;
}

// The scenarios a K1 block holds for the host copy of a table.
extern "C" int rs_forward_scenarios(const void* T_host) {
  int bytes;
  return k1_block(*(const RsTables*)T_host, &bytes);
}

// The model image K1 and K4 stage (forward.cuh carve_tab) of the host copy
// of a table into out (host memory; null: only counted); -> its words.
extern "C" int rs_forward_tab(const void* T_host, float* out) {
  return forward_tab_image(*(const RsTables*)T_host, out);
}

template <int S>
static int launch_k1(const RsTables* T, const float* tab, int B, const K1Io& io, int bytes, cudaStream_t stream) {
  static int opted = 48 * 1024;
  if (bytes > opted) {
    cudaError_t err = cudaFuncSetAttribute(rs_forward_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    opted = bytes;
  }
  rs_forward_kernel<S><<<(B + S - 1) / S, 32 * S, bytes, stream>>>(T, tab, B, io);
  return (int)cudaGetLastError();
}

// K1 on B scenarios: qpos (B, nq), qvel (B, nv), the leaves mass (., nb),
// inertia (., nb, 3), gravity (., 3), armature (., nv) with batch strides
// (in floats; 0: one row for all), into the one output allocation out
// (k1_offset); tab is the model image (rs_forward_tab) on the device. ->
// the CUDA error (cudaErrorInvalidValue where even the wide block's carve
// exceeds the opt-in limit).
extern "C" int rs_forward(const void* T, const void* T_host, const float* tab, const float* qpos, const float* qvel,
                          const float* mass, int mass_bs, const float* inertia, int inertia_bs, const float* gravity,
                          int gravity_bs, const float* armature, int armature_bs, float* out, int B, void* stream) {
  int bytes;
  const int S = k1_block(*(const RsTables*)T_host, &bytes);
  if (bytes > rs_smem_optin()) return (int)cudaErrorInvalidValue;
  const K1Io io{qpos, qvel, mass, inertia, gravity, armature, mass_bs, inertia_bs, gravity_bs, armature_bs, out};
  const RsTables* Td = (const RsTables*)T;
  if (S == RS_S_FORWARD) return launch_k1<RS_S_FORWARD>(Td, tab, B, io, bytes, (cudaStream_t)stream);
  return launch_k1<RS_S_FORWARD_WIDE>(Td, tab, B, io, bytes, (cudaStream_t)stream);
}

extern "C" int rs_tables_size() { return (int)sizeof(RsTables); }

// The shared memory a block may opt in to on the current device, in bytes.
extern "C" int rs_smem_limit() { return rs_smem_optin(); }

#ifdef RS_STAGE_CLOCKS
// The diagnostic build's stage clocks (common.cuh RS_STAMP) of the last
// K1 launch into out (RS_NSTAGES values, host memory), then zeroed.
extern "C" int rs_forward_stage_clocks(long long* out) {
  static const long long zero[RS_NSTAGES] = {};
  if (cudaError_t err = cudaMemcpyFromSymbol(out, rs_stage_clock, sizeof(zero))) return (int)err;
  return (int)cudaMemcpyToSymbol(rs_stage_clock, zero, sizeof(zero));
}
#endif
