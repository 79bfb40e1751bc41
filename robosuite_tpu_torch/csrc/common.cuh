// Shared definitions of the port's CUDA kernels: compile-time maxima, the
// packed model table, the teams that run a scenario, and small algebra.
//
// A scenario runs on a TEAM of threads: its rank and size, `sync`, and
// reductions. On the card the team is one warp (WarpTeam: lanes exchange
// through shuffles and warp-wide reductions, `sync` is __syncwarp), so a
// block holds several scenarios and no stage waits at a block barrier.
// The same device functions also compile as plain C++ over HostTeam, one
// lane, which is how their arithmetic is checked without a GPU
// (tests/test_torch_kernels_host.py).
#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define RS_DEV __device__ __forceinline__
#define RS_HD __host__ __device__ __forceinline__  // also called by the host launchers (the carves)
#else
#define RS_DEV inline
#define RS_HD inline
#endif

RS_DEV int rs_popc(unsigned m) {
#ifdef __CUDA_ARCH__
  return __popc(m);
#else
  return __builtin_popcount(m);
#endif
}

// Order-preserving unsigned key of a float (-0 taken as +0), so a
// warp-wide unsigned minimum finds the smallest value.
RS_DEV unsigned rs_fkey(float v) {
  union { float f; unsigned u; } c;
  c.f = v + 0.0f;
  return (c.u & 0x80000000u) ? ~c.u : (c.u | 0x80000000u);
}

#ifdef __CUDACC__
// One warp runs one scenario.
struct WarpTeam {
  RS_DEV int rank() const { return threadIdx.x & 31; }
  RS_DEV int size() const { return 32; }
  RS_DEV void sync() const { __syncwarp(); }
  RS_DEV unsigned ballot(bool p) const { return __ballot_sync(0xffffffffu, p); }  // bit r: lane r's p
  RS_DEV double sum(double v) const {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  }
  RS_DEV float max(float v) const {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
  }
  // The index of the smallest value over the lanes' (v, idx), the lowest
  // index among equal values.
  RS_DEV int argmin(float v, int idx) const {
    unsigned k = rs_fkey(v);
    unsigned m = __reduce_min_sync(0xffffffffu, k);
    return (int)__reduce_min_sync(0xffffffffu, k == m ? (unsigned)idx : 0xffffffffu);
  }
};

// The whole block as one team (K1's and K4's block-wide stages: the staged
// loads and the output spans).
struct BlockTeam {
  RS_DEV int rank() const { return threadIdx.x; }
  RS_DEV int size() const { return blockDim.x; }
  RS_DEV void sync() const { __syncthreads(); }
};
#endif

#ifndef __CUDACC__
struct float4 {  // the host form of CUDA's 16-byte vector
  float x, y, z, w;
};
#endif

// One lane runs one scenario: the host form of the device code.
struct HostTeam {
  RS_DEV int rank() const { return 0; }
  RS_DEV int size() const { return 1; }
  RS_DEV void sync() const {}
  RS_DEV unsigned ballot(bool p) const { return p ? 1u : 0u; }
  RS_DEV double sum(double v) const { return v; }
  RS_DEV float max(float v) const { return v; }
  RS_DEV int argmin(float, int idx) const { return idx; }
};

// The first index of the smallest of v[0..n) over the team (each lane
// scans its strided share, keeping its earliest minimum, then the team
// argmin keeps the lowest index): the order contact.select_deepest's
// stable sort gives. Every lane gets the index.
template <class Team>
RS_DEV int team_argmin(const Team& tm, const float* v, int n) {
  float bv = INFINITY;
  int bi = n;
  for (int i = tm.rank(); i < n; i += tm.size())
    if (bi == n || v[i] < bv) { bv = v[i]; bi = i; }
  return tm.argmin(bv, bi);
}

// Stage clocks of the fused substep (a diagnostic build only: nvcc
// -DRS_STAGE_CLOCKS, robosuite_tpu_torch/ab_kernels.py): clock64() at the
// end of each stage of block 0's first scenario, read back by
// rs_stage_clocks. In every other build RS_STAMP is nothing.
#define RS_NSTAGES 16
#if defined(RS_STAGE_CLOCKS) && defined(__CUDACC__)
static __device__ long long rs_stage_clock[RS_NSTAGES];
#define RS_STAMP(i)                                                         \
  do {                                                                      \
    if (blockIdx.x == 0 && threadIdx.x == 0) rs_stage_clock[i] = clock64(); \
  } while (0)
#else
#define RS_STAMP(i) ((void)0)
#endif

// Compile-time maxima; the Python side checks a model against them
// before it packs the table (ops/tables.py mirrors these numbers).
#define RS_MAXB 96     // bodies (GR1's 92)
#define RS_MAXJ 56     // joints (GR1's 55)
#define RS_MAXQ 64     // qpos (GR1's 61)
#define RS_MAXV 60     // dofs (GR1's 60)
#define RS_MAXG 176    // geoms
#define RS_MAXS 52     // sites (GR1's 51)
#define RS_MAXU 24     // actuators of the fused substep (K1 and K4 read none)
#define RS_MAXP 64     // candidate pairs
#define RS_MAXK 192    // contact rows (points)
#define RS_MAXE 8      // equality rows of K2 (XArm7's 7)
#define RS_MAXP1 65    // RS_MAXP + 1: a prefix table over the pairs
#define RS_MAXCT 1600  // RS_MAXP * 25: narrowphase candidates, all pairs
#define RS_MAXA 8      // arm dofs
#define RS_MAXGR 12    // gripper actuators (an Inspire hand's 12)
#define RS_MAXPR 896   // (body, dof) pairs with anc != 0 (GR1FloatingBody's 885)
#define RS_MAXV1 61    // RS_MAXV + 1 and RS_MAXB + 1: prefix tables over the dofs and the bodies
#define RS_MAXB1 97
#define RS_MAXV2 3600  // RS_MAXV * RS_MAXV: the mass matrix's entries

// Scenarios a block of K1, K2 and K3 (one warp each) and K4 (one thread
// each), fixed at compile time; `python -m robosuite_tpu_torch.ab_kernels
// sweep` (K1, K4) and `sweep-k3` (K2, K3) build and time other values with
// -D (PERF.md gives the sweeps).
#ifndef RS_S_FORWARD
#define RS_S_FORWARD 4
#endif
#ifndef RS_S_FK
#define RS_S_FK 32
#endif
#ifndef RS_S_SOLVE
#define RS_S_SOLVE 2
#endif
#ifndef RS_S_SUBSTEP
#define RS_S_SUBSTEP 1
#endif
// K1 and K2 take these fewer scenarios a block where the block above
// would not fit the shared memory a block may opt in to (232,448 B on the
// H100): K1 on GR1's 92 bodies at nv 48-60 (245-304 KB at 4), K2 at nv 60
// with 96 slots (244 KB at 2). Narrower worlds keep the blocks above.
#ifndef RS_S_FORWARD_WIDE
#define RS_S_FORWARD_WIDE 2
#endif
#ifndef RS_S_SOLVE_WIDE
#define RS_S_SOLVE_WIDE 1
#endif

#ifdef __CUDACC__
// The shared memory a block may opt in to on the current device, read once.
static inline int rs_smem_optin() {
  static int bytes = 0;
  if (bytes == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return bytes;
}
#endif

// Joint types (MuJoCo enum order) and narrowphase pair kinds.
#define RS_FREE 0
#define RS_BALL 1
#define RS_SLIDE 2
#define RS_HINGE 3
#define RS_PAIR_PLANE_BOX 0
#define RS_PAIR_CAPSULE_BOX 1  // cylinder-box too: the cylinder is a capsule
#define RS_PAIR_BOX_BOX 2
#define RS_PAIR_PLANE_CYLINDER 3
#define RS_PAIR_CAPSULE_CAPSULE 4  // cylinder-cylinder: both cylinders are capsules
#define RS_ACT_MOTOR 0
#define RS_ACT_POSITION 1
#define RS_ACT_VELOCITY 2
#define RS_CTRL_OSC 0        // arm torque laws of the fused substep
#define RS_CTRL_JOINT_POS 1

// The static model, packed once per env (ops/tables.py builds the same
// layout with ctypes; every field is 4 bytes wide, so there is no padding).
struct RsTables {
  int nq, nv, nbody, njnt, ngeom, nsite, nu, npair, nrows;
  int solver_iters, power_iters;
  float dt, impratio;

  int body_parent[RS_MAXB], body_jntadr[RS_MAXB], body_jntnum[RS_MAXB];
  float body_pos[RS_MAXB][3], body_quat[RS_MAXB][4], body_ipos[RS_MAXB][3], body_iquat[RS_MAXB][4];

  int jnt_type[RS_MAXJ], jnt_qposadr[RS_MAXJ], jnt_dofadr[RS_MAXJ];
  float jnt_pos[RS_MAXJ][3], jnt_axis[RS_MAXJ][3], jnt_range[RS_MAXJ][2];
  float jnt_limited[RS_MAXJ], jnt_stiffness[RS_MAXJ];
  float qpos0[RS_MAXQ], qpos_spring[RS_MAXQ];

  int dof_bodyid[RS_MAXV], dof_free_trans[RS_MAXV];
  float dof_damping[RS_MAXV], dof_frictionloss[RS_MAXV];
  float anc[RS_MAXB][RS_MAXV];  // 1 if dof d moves body b
  // the (body, dof) pairs with anc != 0, twice: dof-major (by dof, then
  // body ascending, entry 256 b + d, dof d's run from dof_pr0[d]) and
  // body-major (by body, then dof ascending, entry d, body b's run from
  // body_pr0[b])
  int npr, pr_db[RS_MAXPR], dof_pr0[RS_MAXV1], pr_bd[RS_MAXPR], body_pr0[RS_MAXB1];
  // M[e][d] (index e nv + d, row stride nv) from CRBA's sums: 256 row + col
  // of the (row, col) with body(col) moved by dof row, or -1 where neither
  // dof moves the other's body
  int m_rc[RS_MAXV2];

  int geom_bodyid[RS_MAXG];
  float geom_pos[RS_MAXG][3], geom_quat[RS_MAXG][4], geom_size[RS_MAXG][3];
  int site_bodyid[RS_MAXS];
  float site_pos[RS_MAXS][3], site_quat[RS_MAXS][4];

  int act_kind[RS_MAXU], act_dofadr[RS_MAXU], act_qposadr[RS_MAXU];
  float act_gear[RS_MAXU], act_gain[RS_MAXU], act_ctrllimited[RS_MAXU], act_ctrlrange[RS_MAXU][2];
  float act_forcelimited[RS_MAXU], act_forcerange[RS_MAXU][2];

  // candidate pairs in the contact buffer's group-major order
  int pair_kind[RS_MAXP], pair_g1[RS_MAXP], pair_g2[RS_MAXP], pair_flip[RS_MAXP];
  int pair_npts[RS_MAXP], pair_row[RS_MAXP], pair_body1[RS_MAXP], pair_body2[RS_MAXP];
  float pair_friction[RS_MAXP], pair_solref[RS_MAXP][2], pair_solimp[RS_MAXP][5], pair_margin[RS_MAXP];
  int row_pair[RS_MAXK];
  int pair_k[RS_MAXP];  // the pair's index in the model's pair list
  int pair_cand[RS_MAXP1], ncand;  // each pair's first candidate in the flat list, and their count
  int cand_pi[RS_MAXCT];  // the candidates grouped by code path, each as 32 pair + its index in the pair

  // the arm's controller and the gripper actuators (fused substep): the
  // torque law, its flags, and the row strides of its goal / gains inputs
  int na, eef_site, center_site, uncouple, ngrip;
  int ctrl_type, torque_comp, raw_pd, goal_stride, gains_stride;
  int arm_qv[RS_MAXA], arm_qp[RS_MAXA], arm_act[RS_MAXA];
  float torque_lo[RS_MAXA], torque_hi[RS_MAXA], initial_joint[RS_MAXA];
  int grip_act[RS_MAXGR];
};

// Carves consecutive regions out of shared memory, in 4-byte words; with
// a null base it only counts them (the size a launch asks for). A region
// holds S scenarios' chunks one after another and hands out scenario s's,
// so that a block's chunks of one array form one contiguous span (K1's
// block-contiguous outputs); S = 1 carves one scenario's memory alone.
struct Carver {
  float* base;
  int w;
  int S = 1, s = 0;
  RS_HD float* take(int words, int align = 1) {
    w = (w + align - 1) / align * align;
    float* p = base ? base + w + s * words : nullptr;
    w += S * words;
    return p;
  }
  RS_HD double* take_d(int n) { return reinterpret_cast<double*>(take(2 * n, 2)); }
};

// ---- small vector algebra ------------------------------------------------

// A product, sum or difference rounded on its own, never fused into an FMA
// with its neighbour: the cross products and the quaternion algebra below
// round as their plain PyTorch versions do (utils/transforms.py, one
// rounding an operation), so the poses of the tree walk (K1, K3, K4) equal
// kinematics.fk's bit for bit in most entries and near-ties in the contact
// decisions fall the same way in both. The host build fuses nothing.
#ifdef __CUDA_ARCH__
#define RS_MUL(a, b) __fmul_rn((a), (b))
#define RS_ADD(a, b) __fadd_rn((a), (b))
#define RS_SUB(a, b) __fsub_rn((a), (b))
#else
#define RS_MUL(a, b) ((a) * (b))
#define RS_ADD(a, b) ((a) + (b))
#define RS_SUB(a, b) ((a) - (b))
#endif

RS_DEV void v3_cross(const float* a, const float* b, float* o) {
  float x = RS_SUB(RS_MUL(a[1], b[2]), RS_MUL(a[2], b[1]));
  float y = RS_SUB(RS_MUL(a[2], b[0]), RS_MUL(a[0], b[2]));
  float z = RS_SUB(RS_MUL(a[0], b[1]), RS_MUL(a[1], b[0]));
  o[0] = x; o[1] = y; o[2] = z;
}

RS_DEV float v3_dot(const float* a, const float* b) { return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]; }

RS_DEV void quat_mul(const float* q, const float* r, float* o) {
  float w = RS_SUB(RS_SUB(RS_SUB(RS_MUL(q[0], r[0]), RS_MUL(q[1], r[1])), RS_MUL(q[2], r[2])), RS_MUL(q[3], r[3]));
  float x = RS_SUB(RS_ADD(RS_ADD(RS_MUL(q[0], r[1]), RS_MUL(q[1], r[0])), RS_MUL(q[2], r[3])), RS_MUL(q[3], r[2]));
  float y = RS_ADD(RS_ADD(RS_SUB(RS_MUL(q[0], r[2]), RS_MUL(q[1], r[3])), RS_MUL(q[2], r[0])), RS_MUL(q[3], r[1]));
  float z = RS_ADD(RS_SUB(RS_ADD(RS_MUL(q[0], r[3]), RS_MUL(q[1], r[2])), RS_MUL(q[2], r[1])), RS_MUL(q[3], r[0]));
  o[0] = w; o[1] = x; o[2] = y; o[3] = z;
}

// v + 2 (w (u x v) + u x (u x v)) for q = (w, u)
RS_DEV void quat_rot(const float* q, const float* v, float* o) {
  float uv[3], uuv[3];
  v3_cross(q + 1, v, uv);
  v3_cross(q + 1, uv, uuv);
  for (int i = 0; i < 3; ++i) o[i] = RS_ADD(v[i], RS_MUL(2.0f, RS_ADD(RS_MUL(q[0], uv[i]), uuv[i])));
}

// row-major 3x3 rotation of a wxyz quaternion, normalised first
RS_DEV void quat2mat(const float* q, float* m) {
  float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  float inv = 1.0f / fmaxf(n, 1e-8f);
  float w = q[0] * inv, x = q[1] * inv, y = q[2] * inv, z = q[3] * inv;
  float xx = x * x, yy = y * y, zz = z * z, xy = x * y, xz = x * z, yz = y * z;
  float wx = w * x, wy = w * y, wz = w * z;
  m[0] = 1.0f - 2.0f * (yy + zz); m[1] = 2.0f * (xy - wz); m[2] = 2.0f * (xz + wy);
  m[3] = 2.0f * (xy + wz); m[4] = 1.0f - 2.0f * (xx + zz); m[5] = 2.0f * (yz - wx);
  m[6] = 2.0f * (xz - wy); m[7] = 2.0f * (yz + wx); m[8] = 1.0f - 2.0f * (xx + yy);
}

RS_DEV float clampf(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }
RS_DEV float signf(float x) { return (float)((x > 0.0f) - (x < 0.0f)); }

// ---- small dense factorisations over a team (double precision) ------------

// Lower Cholesky factor in place: L holds A's lower triangle on entry (row
// stride ld), pivots floored at 1e-12 (ops/linalg.chol_factor). Column by
// column; each lane takes rows, its dot product as four independent sums
// added in a fixed order. The upper triangle is neither read nor written.
template <class Team>
RS_DEV void chol_team(const Team& tm, double* L, int n, int ld) {
  for (int j = 0; j < n; ++j) {
    const double* Lj = L + j * ld;
    for (int i = j + tm.rank(); i < n; i += tm.size()) {
      const double* Li = L + i * ld;
      double t[4] = {Li[j], 0.0, 0.0, 0.0};
      int k = 0;
      for (; k + 4 <= j; k += 4)
#pragma unroll
        for (int u = 0; u < 4; ++u) t[u] -= Li[k + u] * Lj[k + u];
      for (; k < j; ++k) t[0] -= Li[k] * Lj[k];
      const double d = (t[0] + t[1]) + (t[2] + t[3]);
      L[i * ld + j] = i == j ? sqrt(fmax(d, 1e-12)) : d;
    }
    tm.sync();
    const double d = L[j * ld + j];
    for (int i = j + 1 + tm.rank(); i < n; i += tm.size()) L[i * ld + j] /= d;
    tm.sync();
  }
}

// Solve L x = b in place (b in shared memory), column by column: each
// step divides one entry and the lanes update the rows below. Ends
// synchronised.
template <class Team>
RS_DEV void fwd_solve_team(const Team& tm, const double* L, double* b, int n, int ld) {
  for (int k = 0; k < n; ++k) {
    const double bk = b[k] / L[k * ld + k];
    for (int i = k + 1 + tm.rank(); i < n; i += tm.size()) b[i] -= L[i * ld + k] * bk;
    tm.sync();
  }
  for (int i = tm.rank(); i < n; i += tm.size()) b[i] /= L[i * ld + i];
  tm.sync();
}

// Solve L L^T x = b in place: fwd_solve_team, then the back substitution
// column by column (the lanes update the rows above). Ends synchronised.
template <class Team>
RS_DEV void chol_solve_team(const Team& tm, const double* L, double* b, int n, int ld) {
  fwd_solve_team(tm, L, b, n, ld);
  for (int k = n - 1; k >= 0; --k) {
    const double bk = b[k] / L[k * ld + k];
    for (int i = tm.rank(); i < k; i += tm.size()) b[i] -= L[k * ld + i] * bk;
    tm.sync();
  }
  for (int i = tm.rank(); i < n; i += tm.size()) b[i] /= L[i * ld + i];
  tm.sync();
}

// The same solve on one lane, for a right-hand side the lane owns alone
// (the columns of an inverse, one lane each).
RS_DEV void chol_solve_d(const double* L, double* b, int n, int lda) {
  for (int i = 0; i < n; ++i) {
    double s = b[i];
    for (int k = 0; k < i; ++k) s -= L[i * lda + k] * b[k];
    b[i] = s / L[i * lda + i];
  }
  for (int i = n - 1; i >= 0; --i) {
    double s = b[i];
    for (int k = i + 1; k < n; ++k) s -= L[k * lda + i] * b[k];
    b[i] = s / L[i * lda + i];
  }
}
