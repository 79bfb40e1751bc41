// OSC_POSE torque law for one scenario over its team (double precision):
// controllers/parts/osc.py run_world with control_utils.opspace_matrices
// (robosuite osc.py:437-495, control_utils.py:7-82), for a world-frame goal.
//   goal  = [desired_pos (3), desired_ori (3x3 row-major)]
//   gains = [kp (6), kd (6)]
// Replaces the OSC section of robosuite_tpu/ops/pallas_substep.py
// _make_substep_kernel. The operational-space inverses follow the plain
// version's _pinv_sym: power-of-two equilibration, a 1e-8 ridge, adjugate
// inverse for 3x3 blocks and Cholesky for the 6x6 one. Every matrix
// product goes one entry per lane (each entry's sum in the one-thread
// order); the 7x7 and 6x6 inverses factor over the team (chol_team) and
// solve one column per lane; the 3x3 adjugates go one entry per lane.
// Matrices live in OscScratch (shared memory), row stride 8.
#pragma once

#include "forward.cuh"

struct OscScratch {
  double J[6 * 8], Ma[64], L[64], Xt[64], Minv[64], Mi[64], JM[6 * 8], Li[64], dsc[8], hat[64], Lit[64], Lf[64],
      Lp[64], Lo[64], MJt[64], Jbar[64], wr[8], pose[8];
};

#define RS_OSC_WORDS ((int)(sizeof(OscScratch) / 4))

// Entry (r, k) of the ridge-regularised, equilibrated inverse of the
// symmetric PSD 3x3 block A (row stride 8; control_utils._pinv_sym with
// the adjugate inverse).
RS_DEV double pinv3_entry(const double* A, int r, int k) {
  double dsc[3], h[9];
  for (int i = 0; i < 3; ++i) dsc[i] = exp2(rint(log2(sqrt(fmax(A[i * 8 + i], 1e-20)))));
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) h[i * 3 + j] = A[i * 8 + j] / dsc[i] / dsc[j] + (i == j ? 1e-8 + 1e-12 : 0.0);
  double a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5], g = h[6], hh = h[7], i = h[8];
  double adj[9] = {e * i - f * hh, c * hh - b * i, b * f - c * e,
                   f * g - d * i, a * i - c * g, c * d - a * f,
                   d * hh - e * g, b * g - a * hh, a * e - b * d};
  double det = a * adj[0] + b * adj[3] + c * adj[6];
  double inv_det = 1.0 / (fabs(det) > 1e-12 ? det : 1e-12);
  return adj[r * 3 + k] * inv_det / dsc[r] / dsc[k];
}

// The inverse of the SPD n x n matrix in L (row stride 8, factored in
// place) into outT, transposed (row j = column j of the inverse): the team
// factors, then lane j solves column j.
template <class Team>
RS_DEV void inv_spd_team(const Team& tm, double* L, double* outT, int n) {
  chol_team(tm, L, n, 8);
  for (int j = tm.rank(); j < n; j += tm.size()) {
    double* col = outT + j * 8;
    for (int i = 0; i < n; ++i) col[i] = (i == j) ? 1.0 : 0.0;
    chol_solve_d(L, col, n, 8);
  }
  tm.sync();
}

template <class Team>
RS_DEV void osc_team(const Team& tm, const RsTables& T, const Fwd& s, const float* goal, const float* gains,
                     float* tau, OscScratch& o) {
  const int tid = tm.rank(), nt = tm.size();
  const int na = T.na, nv = T.nv;
  const int eb = T.site_bodyid[T.eef_site], cb = T.site_bodyid[T.center_site];
  float sp[3], sR[9], op[3], oR[9];  // on every lane
  frame_pose(s, eb, T.site_pos[T.eef_site], T.site_quat[T.eef_site], sp, sR);
  frame_pose(s, cb, T.site_pos[T.center_site], T.site_quat[T.center_site], op, oR);

  // the wrench F: pose error on every lane, the two point velocities
  // summed over the lanes (one dof each)
  double F[6];
  {
    double oe[3] = {0, 0, 0};
    for (int i = 0; i < 3; ++i) {  // 0.5 * sum_i current[:, i] x desired[:, i]
      double cu[3] = {sR[i], sR[3 + i], sR[6 + i]}, de[3] = {goal[3 + i], goal[6 + i], goal[9 + i]};
      oe[0] += cu[1] * de[2] - cu[2] * de[1];
      oe[1] += cu[2] * de[0] - cu[0] * de[2];
      oe[2] += cu[0] * de[1] - cu[1] * de[0];
    }
    double v[12] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};  // eef (lin, ang), center (lin, ang)
    for (int d = tid; d < nv; d += nt) {
      const int bodies[2] = {eb, cb};
      const float* pts[2] = {sp, op};
      for (int h = 0; h < 2; ++h) {
        if (T.anc[bodies[h]][d] == 0.0f) continue;
        float c[3];
        v3_cross(s.sa[d], pts[h], c);
        for (int i = 0; i < 3; ++i) {
          v[6 * h + i] += (double)s.qd[d] * (s.sl[d][i] + c[i]);
          v[6 * h + 3 + i] += (double)s.qd[d] * s.sa[d][i];
        }
      }
    }
    for (int i = 0; i < 12; ++i) v[i] = tm.sum(v[i]);
    for (int i = 0; i < 3; ++i) {
      F[i] = ((double)goal[i] - sp[i]) * gains[i] + (v[6 + i] - v[i]) * gains[6 + i];
      F[3 + i] = 0.5 * oe[i] * gains[3 + i] + (v[9 + i] - v[3 + i]) * gains[9 + i];
    }
  }
  // J (6 x na): the eef site's jacobian over the arm dofs; M_arm
  for (int e = tid; e < 6 * na; e += nt) {
    int r = e / na, a = e % na, d = T.arm_qv[a];
    float m = T.anc[eb][d], c[3];
    v3_cross(s.sa[d], sp, c);
    o.J[r * 8 + a] = r < 3 ? (double)m * (s.sl[d][r] + c[r]) : (double)m * s.sa[d][r - 3];
  }
  for (int e = tid; e < na * na; e += nt) {
    int a = e / na, b = e % na;
    o.Ma[a * 8 + b] = o.L[a * 8 + b] = s.M[T.arm_qv[a] * nv + T.arm_qv[b]];
  }
  tm.sync();
  // M^-1 with one Newton refinement X (2I - M X); X[k][j] = Xt[j][k]
  inv_spd_team(tm, o.L, o.Xt, na);
  for (int e = tid; e < na * na; e += nt) {
    int i = e / na, j = e % na;
    double v = 0.0;
    for (int k = 0; k < na; ++k) v += o.Ma[i * 8 + k] * o.Xt[j * 8 + k];
    o.Minv[i * 8 + j] = (i == j ? 2.0 : 0.0) - v;
  }
  tm.sync();
  for (int e = tid; e < na * na; e += nt) {
    int i = e / na, j = e % na;
    double v = 0.0;
    for (int k = 0; k < na; ++k) v += o.Xt[k * 8 + i] * o.Minv[k * 8 + j];
    o.Mi[i * 8 + j] = v;
  }
  tm.sync();
  // Lambda^-1 = J M^-1 J^T and its blocks
  for (int e = tid; e < 6 * na; e += nt) {
    int i = e / na, j = e % na;
    double v = 0.0;
    for (int k = 0; k < na; ++k) v += o.J[i * 8 + k] * o.Mi[k * 8 + j];
    o.JM[i * 8 + j] = v;
  }
  tm.sync();
  for (int e = tid; e < 36; e += nt) {
    int i = e / 6, j = e % 6;
    double v = 0.0;
    for (int k = 0; k < na; ++k) v += o.JM[i * 8 + k] * o.J[j * 8 + k];
    o.Li[i * 8 + j] = v;
  }
  tm.sync();
  // the 6x6 pseudo-inverse (equilibrate, ridge, Cholesky) and the two 3x3
  // ones (adjugate, one entry per lane)
  for (int i = tid; i < 6; i += nt) o.dsc[i] = exp2(rint(log2(sqrt(fmax(o.Li[i * 8 + i], 1e-20)))));
  tm.sync();
  for (int e = tid; e < 36 + 18; e += nt) {
    if (e < 36) {
      int i = e / 6, j = e % 6;
      o.hat[i * 8 + j] = o.Li[i * 8 + j] / o.dsc[i] / o.dsc[j] + (i == j ? 1e-8 + 1e-12 : 0.0);
    } else {
      int m = (e - 36) / 9, r = (e - 36) % 9 / 3, k = (e - 36) % 3;
      (m == 0 ? o.Lp : o.Lo)[r * 8 + k] = pinv3_entry(o.Li + 3 * m * 9, r, k);
    }
  }
  tm.sync();
  inv_spd_team(tm, o.hat, o.Lit, 6);
  for (int e = tid; e < 36; e += nt) {
    int i = e / 6, j = e % 6;
    o.Lf[i * 8 + j] = o.Lit[j * 8 + i] / o.dsc[i] / o.dsc[j];
  }
  tm.sync();
  for (int i = tid; i < 6; i += nt) {
    double v = 0.0;
    if (T.uncouple) {
      const double* B = i < 3 ? o.Lp : o.Lo;
      const int h = i < 3 ? 0 : 3, r = i - h;
      v = B[r * 8] * F[h] + B[r * 8 + 1] * F[h + 1] + B[r * 8 + 2] * F[h + 2];
    } else {
      for (int k = 0; k < 6; ++k) v += o.Lf[i * 8 + k] * F[k];
    }
    o.wr[i] = v;
  }
  // Jbar = M^-1 J^T Lambda, N = I - Jbar J; nullspace posture torques
  for (int e = tid; e < na * 6; e += nt) {
    int i = e / 6, j = e % 6;
    double v = 0.0;
    for (int k = 0; k < na; ++k) v += o.Mi[i * 8 + k] * o.J[j * 8 + k];
    o.MJt[i * 8 + j] = v;
  }
  const double kv = 2.0 * sqrt(10.0);
  for (int i = tid; i < na; i += nt) {
    double v = 0.0;
    for (int j = 0; j < na; ++j)
      v += s.M[T.arm_qv[i] * nv + T.arm_qv[j]] *
           (10.0 * ((double)T.initial_joint[j] - s.q[T.arm_qp[j]]) - kv * s.qd[T.arm_qv[j]]);
    o.pose[i] = v;
  }
  tm.sync();
  for (int e = tid; e < na * 6; e += nt) {
    int i = e / 6, j = e % 6;
    double v = 0.0;
    for (int k = 0; k < 6; ++k) v += o.MJt[i * 8 + k] * o.Lf[k * 8 + j];
    o.Jbar[i * 8 + j] = v;
  }
  tm.sync();
  for (int i = tid; i < na; i += nt) {
    double v = s.bias[T.arm_qv[i]];
    for (int j = 0; j < 6; ++j) v += o.J[j * 8 + i] * o.wr[j];
    for (int j = 0; j < na; ++j) {  // (N^T pose)_i = sum_j N[j][i] pose_j
      double jbj = 0.0;
      for (int k = 0; k < 6; ++k) jbj += o.Jbar[j * 8 + k] * o.J[k * 8 + i];
      v += ((i == j ? 1.0 : 0.0) - jbj) * o.pose[j];
    }
    tau[i] = clampf((float)v, T.torque_lo[i], T.torque_hi[i]);
  }
  tm.sync();
}
