// Shared definitions of the port's CUDA kernels: compile-time maxima, the
// packed model table, and the thread/barrier/reduction shims.
//
// Every kernel runs ONE thread block per scenario. Device code is written
// as block functions over rs_tid()/rs_nthreads() with RS_SYNC() barriers,
// so the same headers also compile as plain C++ (one thread per block),
// which is how their arithmetic can be checked without a GPU.
#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define RS_DEV __device__ __forceinline__
#define RS_SYNC() __syncthreads()
RS_DEV int rs_tid() { return threadIdx.x; }
RS_DEV int rs_nthreads() { return blockDim.x; }
RS_DEV float rs_warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}
#else
#define RS_DEV inline
#define RS_SYNC() ((void)0)
inline int rs_tid() { return 0; }
inline int rs_nthreads() { return 1; }
inline float rs_warp_sum(float v) { return v; }
#endif

// Compile-time maxima; the Python side checks a model against them
// before it packs the table (ops/tables.py mirrors these numbers).
#define RS_MAXB 32     // bodies
#define RS_MAXJ 16     // joints
#define RS_MAXQ 24     // qpos
#define RS_MAXV 24     // dofs
#define RS_MAXG 96     // geoms
#define RS_MAXS 16     // sites
#define RS_MAXU 16     // actuators
#define RS_MAXP 32     // candidate pairs
#define RS_MAXK 96     // contact rows (points)
#define RS_MAXNTOT (3 * RS_MAXK)
#define RS_MAXA 8      // arm dofs
#define RS_MAXGR 4     // gripper actuators
#define RS_MAXCAND 25  // narrowphase candidates per pair (box-box)
#define RS_THREADS 128 // threads per block (one block per scenario)

// Joint types (MuJoCo enum order) and narrowphase pair kinds.
#define RS_FREE 0
#define RS_BALL 1
#define RS_SLIDE 2
#define RS_HINGE 3
#define RS_PAIR_PLANE_BOX 0
#define RS_PAIR_CAPSULE_BOX 1  // cylinder-box too: the cylinder is a capsule
#define RS_PAIR_BOX_BOX 2
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
  uint32_t body_desc[RS_MAXB];  // bit b2 set when b is an ancestor of (or is) b2
  float body_pos[RS_MAXB][3], body_quat[RS_MAXB][4], body_ipos[RS_MAXB][3], body_iquat[RS_MAXB][4];

  int jnt_type[RS_MAXJ], jnt_qposadr[RS_MAXJ], jnt_dofadr[RS_MAXJ];
  float jnt_pos[RS_MAXJ][3], jnt_axis[RS_MAXJ][3], jnt_range[RS_MAXJ][2];
  float jnt_limited[RS_MAXJ], jnt_stiffness[RS_MAXJ];
  float qpos0[RS_MAXQ], qpos_spring[RS_MAXQ];

  int dof_bodyid[RS_MAXV], dof_free_trans[RS_MAXV];
  float dof_damping[RS_MAXV], dof_frictionloss[RS_MAXV];
  float anc[RS_MAXB][RS_MAXV];  // 1 if dof d moves body b

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

  // the arm's controller and the gripper actuators (fused substep): the
  // torque law, its flags, and the row strides of its goal / gains inputs
  int na, eef_site, center_site, uncouple, ngrip;
  int ctrl_type, torque_comp, raw_pd, goal_stride, gains_stride;
  int arm_qv[RS_MAXA], arm_qp[RS_MAXA], arm_act[RS_MAXA];
  float torque_lo[RS_MAXA], torque_hi[RS_MAXA], initial_joint[RS_MAXA];
  int grip_act[RS_MAXGR];
};

// ---- small vector algebra ------------------------------------------------

RS_DEV void v3_cross(const float* a, const float* b, float* o) {
  float x = a[1] * b[2] - a[2] * b[1];
  float y = a[2] * b[0] - a[0] * b[2];
  float z = a[0] * b[1] - a[1] * b[0];
  o[0] = x; o[1] = y; o[2] = z;
}

RS_DEV float v3_dot(const float* a, const float* b) { return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]; }

RS_DEV void quat_mul(const float* q, const float* r, float* o) {
  float w = q[0] * r[0] - q[1] * r[1] - q[2] * r[2] - q[3] * r[3];
  float x = q[0] * r[1] + q[1] * r[0] + q[2] * r[3] - q[3] * r[2];
  float y = q[0] * r[2] - q[1] * r[3] + q[2] * r[0] + q[3] * r[1];
  float z = q[0] * r[3] + q[1] * r[2] - q[2] * r[1] + q[3] * r[0];
  o[0] = w; o[1] = x; o[2] = y; o[3] = z;
}

// v + 2 (w (u x v) + u x (u x v)) for q = (w, u)
RS_DEV void quat_rot(const float* q, const float* v, float* o) {
  float uv[3], uuv[3];
  v3_cross(q + 1, v, uv);
  v3_cross(q + 1, uv, uuv);
  for (int i = 0; i < 3; ++i) o[i] = v[i] + 2.0f * (q[0] * uv[i] + uuv[i]);
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

// Sum of v over the block, returned to every thread. `red` holds one float
// per warp; the leading barrier guards it against the previous call.
RS_DEV float block_sum(float v, float* red) {
  v = rs_warp_sum(v);
  int lane = rs_tid() & 31, warp = rs_tid() >> 5, nw = (rs_nthreads() + 31) >> 5;
  RS_SYNC();
  if (lane == 0) red[warp] = v;
  RS_SYNC();
  float s = 0.0f;
  for (int i = 0; i < nw; ++i) s += red[i];
  return s;
}

// ---- small dense factorisations (one thread, double precision) -----------

// Lower Cholesky factor, pivots floored at 1e-12 (ops/linalg.chol_factor).
RS_DEV void chol_d(const double* A, double* L, int n, int lda) {
  for (int j = 0; j < n; ++j) {
    double s = A[j * lda + j];
    for (int k = 0; k < j; ++k) s -= L[j * lda + k] * L[j * lda + k];
    double d = sqrt(fmax(s, 1e-12));
    L[j * lda + j] = d;
    for (int i = j + 1; i < n; ++i) {
      double t = A[i * lda + j];
      for (int k = 0; k < j; ++k) t -= L[i * lda + k] * L[j * lda + k];
      L[i * lda + j] = t / d;
    }
    for (int i = 0; i < j; ++i) L[i * lda + j] = 0.0;
  }
}

// Solve L L^T x = b in place.
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
