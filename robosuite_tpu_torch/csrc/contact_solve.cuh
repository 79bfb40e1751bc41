// Constrained velocity update of one scenario, as a team function: the
// smooth acceleration, the elliptic-cone dual QP by APGD (with bilateral
// equality rows beside the cone rows), and the implicit-damping velocity
// solve.
//
// Replaces robosuite_tpu/ops/pallas_contact.py constrained_vel_lanes and
// computes what its plain version computes (ops/contact_solve.py
// vel_update_plain, the JAX _vel_update_xla / _apgd_xla):
//   Y = L^-1 Jf^T (L L^T = M), A = Y^T Y, R = reg3 * max(diag A, 1e-8),
//   rhs = aref - Y^T L^T qacc_smooth, 8 power iterations on the active rows
//   for the step 1 / (1.1 L), 30 APGD iterations with the cone projection,
//   qvel' = qvel + dt (M + dt D)^-1 (qfrc_smooth + L Y f - D qvel).
//
// Rows are grouped [normals (K) | t1 (K) | t2 (K) | equality (ne)], ntot =
// 3 K + ne. Only the active rows (act > 0, a few of the K) and the ne
// equality rows carry force: the cone projection zeroes f and y on every
// other row, and the masked power iteration zeroes v there after its first
// product. So the solve compacts the active rows (compact_active) and
// whitens, multiplies and projects only their columns and the equality
// columns, which are always active and never projected (the JAX
// _apgd_xla's ne branch). The one product that sees the inactive columns, the
// first power iteration's Y v with v = 1e-6 / |v| there, takes their part
// as L^-1 (sum of those columns of Jf^T) times that value: one triangular
// solve instead of one per column. The products Y x (one lane per dof) and
// Y^T (Y x) (one lane per column) sum in float32, as the plain version
// does, in a fixed order, so the result does not depend on how the lanes
// split the work. The two nv x nv Cholesky factorisations and their solves
// run in double over the lanes (common.cuh chol_team). Y overwrites Jf^T in
// shared memory.
#pragma once

#include "common.cuh"

// One scenario's solver arrays in shared memory; Y (nv x ntot, row stride
// ldy) is carved by the caller (y_words). L has row stride ld = nv | 1 and
// Y ldy = ntot | 1 (odd, so lanes on different rows of one column fall in
// different banks). ne: the equality rows.
struct Solve {
  float *Y, *aref, *R, *rhs, *f, *y, *v, *w, *mu, *act, *qfrc, *qvel, *damp;
  double *L, *b, *vts, *acc;
  int* rows;
  int ld, ldy, ne;
};

// The words of Y for nv dofs, K contact rows and ne equality rows.
RS_HD int y_words(int nv, int K, int ne) { return nv * ((3 * K + ne) | 1); }

// Carve of Solve for nv dofs, K contact rows and ne equality rows (not Y).
// rhs overwrites aref (the whitening reads a column's aref once, then
// writes its rhs), and v, the power iteration's vector, shares y, APGD's
// (v is dead before y is set).
RS_HD void carve_solve(int nv, int K, int ne, Carver& c, Solve& s) {
  const int ntot = 3 * K + ne;
  s.ne = ne;
  s.aref = s.rhs = c.take(ntot); s.R = c.take(ntot); s.f = c.take(ntot);
  s.y = s.v = c.take(ntot); s.w = c.take(ntot);
  s.mu = c.take(K); s.act = c.take(K);
  s.qfrc = c.take(nv); s.qvel = c.take(nv); s.damp = c.take(nv);
  s.rows = reinterpret_cast<int*>(c.take(K));
  s.ld = nv | 1;
  s.ldy = ntot | 1;
  s.L = c.take_d(nv * s.ld); s.b = c.take_d(nv); s.vts = c.take_d(nv); s.acc = c.take_d(nv);
}

// The rows with act > 0, in row order, into rows; -> their count. Ends
// synchronised.
template <class Team>
RS_DEV int compact_active(const Team& tm, const float* act, int K, int* rows) {
  int n = 0;
  for (int k0 = 0; k0 < K; k0 += tm.size()) {
    const int k = k0 + tm.rank();
    const bool a = k < K && act[k] > 0.0f;
    const unsigned m = tm.ballot(a);
    if (a) rows[n + rs_popc(m & ((1u << tm.rank()) - 1u))] = k;
    n += rs_popc(m);
  }
  tm.sync();
  return n;
}

// Column j of the 3 na + ne columns that carry force: the na active rows'
// grouped [normals | t1 | t2], then the equality rows.
RS_DEV int active_col(const Solve& s, int K, int na, int j) {
  return j < 3 * na ? (j / na) * K + s.rows[j % na] : 3 * K + (j - 3 * na);
}

// Row c's power-iteration mask: its contact's act, 1 on an equality row.
RS_DEV float row_mask(const Solve& s, int K, int c) { return c < 3 * K ? s.act[c % K] : 1.0f; }

// s.acc[i] = (Y x)_i over the active and equality columns, plus zscale *
// s.acc[i] where zscale is not 0 (the first power iteration's inactive
// part), in float32, one lane per dof; four independent sums (normals, t1,
// t2, equality) added in a fixed order. Ends synchronised.
template <class Team>
RS_DEV void y_times(const Team& tm, const Solve& s, int nv, int K, int na, const float* x, double zscale) {
  for (int i = tm.rank(); i < nv; i += tm.size()) {
    const float* row = s.Y + i * s.ldy;
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int r = 0; r < na; ++r) {
      const int k = s.rows[r];
#pragma unroll
      for (int j = 0; j < 3; ++j) a[j] += row[j * K + k] * x[j * K + k];
    }
    for (int e = 3 * K; e < 3 * K + s.ne; ++e) a[3] += row[e] * x[e];
    s.acc[i] = (double)((zscale == 0.0 ? 0.0f : (float)s.acc[i] * (float)zscale) + a[0] + a[1] + a[2] + a[3]);
  }
  tm.sync();
}

// out[c] = R[c] x[c] + (Y^T s.acc)[c] at the active and equality columns,
// in float32 (four independent sums over the dofs, added in a fixed
// order), one lane per column. Ends synchronised.
template <class Team>
RS_DEV void yt_times(const Team& tm, const Solve& s, int nv, int K, int na, const float* x, float* out) {
  for (int j = tm.rank(); j < 3 * na + s.ne; j += tm.size()) {
    const int c = active_col(s, K, na, j);
    float v[4] = {s.R[c] * x[c], 0.0f, 0.0f, 0.0f};
    int i = 0;
    for (; i + 4 <= nv; i += 4)
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] += s.Y[(i + u) * s.ldy + c] * (float)s.acc[i + u];
    for (; i < nv; ++i) v[0] += s.Y[i * s.ldy + c] * (float)s.acc[i];
    out[c] = (v[0] + v[1]) + (v[2] + v[3]);
  }
  tm.sync();
}

// Expects Y (= Jf^T), aref, R (= reg3), mu, act, qfrc, qvel, damp loaded and
// the team synchronised, M given (float, row stride nv). Writes f into s.f
// and the new velocity into qvel_out; ends synchronised.
template <class Team>
RS_DEV void contact_solve_team(const Team& tm, const Solve& s, const float* M, int nv, int K, int iters,
                               int power_iters, float dt, float* qvel_out) {
  const int tid = tm.rank(), nt = tm.size();
  const int ntot = 3 * K + s.ne, ld = s.ld, ldy = s.ldy;
  // ---- M = L L^T and the smooth acceleration (double) ---------------------
  for (int e = tid; e < nv * nv; e += nt)
    if (e % nv <= e / nv) s.L[(e / nv) * ld + e % nv] = M[e];
  for (int i = tid; i < nv; i += nt) s.b[i] = (double)s.qfrc[i] - (double)s.damp[i] * s.qvel[i];
  tm.sync();
  chol_team(tm, s.L, nv, ld);
  chol_solve_team(tm, s.L, s.b, nv, ld);
  for (int i = tid; i < nv; i += nt) {  // vts = L^T qacc_smooth
    double v = 0.0;
    for (int k = i; k < nv; ++k) v += s.L[k * ld + i] * s.b[k];
    s.vts[i] = v;
  }
  const int na = compact_active(tm, s.act, K, s.rows), nc = 3 * na + s.ne;
  // ---- the inactive columns' sum of Jf^T, whitened: z = L^-1 u in s.acc ---
  for (int i = tid; i < nv; i += nt) {
    double u[3] = {0.0, 0.0, 0.0};
    for (int k = 0; k < K; ++k)
      if (!(s.act[k] > 0.0f)) {
#pragma unroll
        for (int j = 0; j < 3; ++j) u[j] += s.Y[i * ldy + j * K + k];
      }
    s.acc[i] = u[0] + u[1] + u[2];
  }
  tm.sync();
  fwd_solve_team(tm, s.L, s.acc, nv, ld);
  // ---- whitened operator Y = L^-1 Jf^T on the active columns, in place -----
  for (int j = tid; j < nc; j += nt) {
    const int c = active_col(s, K, na, j);
    double a0 = 0.0, dA = 0.0;
    for (int i = 0; i < nv; ++i) {
      const double* Li = s.L + i * ld;
      double v[4] = {s.Y[i * ldy + c], 0.0, 0.0, 0.0};  // four independent sums, added in a fixed order
      int k = 0;
      for (; k + 4 <= i; k += 4)
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] -= Li[k + u] * (double)s.Y[(k + u) * ldy + c];
      for (; k < i; ++k) v[0] -= Li[k] * (double)s.Y[k * ldy + c];
      const float yi = (float)(((v[0] + v[1]) + (v[2] + v[3])) / Li[i]);
      s.Y[i * ldy + c] = yi;
      dA += (double)yi * yi;
      a0 += (double)yi * s.vts[i];
    }
    s.R[c] *= fmaxf((float)dA, 1e-8f);
    s.rhs[c] = s.aref[c] - (float)a0;
  }
  tm.sync();
  RS_STAMP(10);
  // ---- step size: power iteration on the active and equality rows --------
  double ss = 0.0;
  for (int c = tid; c < ntot; c += nt) {
    const float a = row_mask(s, K, c) + 1e-6f;
    ss += (double)(a * a);
  }
  const float inv0 = 1.0f / fmaxf(sqrtf((float)tm.sum(ss)), 1e-9f);
  for (int j = tid; j < nc; j += nt) {
    const int c = active_col(s, K, na, j);
    s.v[c] = (row_mask(s, K, c) + 1e-6f) * inv0;
  }
  tm.sync();
  y_times(tm, s, nv, K, na, s.v, (double)(1e-6f * inv0));
  for (int it = 0;; ++it) {
    yt_times(tm, s, nv, K, na, s.v, s.w);  // masked: the inactive columns of w are 0
    if (it == power_iters) break;
    double ws = 0.0;
    for (int j = tid; j < nc; j += nt) {
      const float wc = s.w[active_col(s, K, na, j)];
      ws += (double)wc * wc;
    }
    const float inv = 1.0f / sqrtf(fmaxf((float)tm.sum(ws), 1e-18f));
    for (int j = tid; j < nc; j += nt) {
      const int c = active_col(s, K, na, j);
      s.v[c] = s.w[c] * inv;
    }
    tm.sync();
    y_times(tm, s, nv, K, na, s.v, 0.0);
  }
  double vw = 0.0;
  for (int j = tid; j < nc; j += nt) {
    const int c = active_col(s, K, na, j);
    vw += (double)s.v[c] * s.w[c];
  }
  const float inv_L = 1.0f / (1.1f * fmaxf((float)tm.sum(vw), 1e-6f));
  RS_STAMP(11);
  // ---- APGD on the cone-constrained dual (f, y are 0 off the active and
  // equality rows; an equality row's step is not projected) ---------------
  for (int c = tid; c < ntot; c += nt) s.f[c] = s.y[c] = 0.0f;
  tm.sync();
  float tk = 1.0f;
  for (int it = 0; it < iters; ++it) {
    y_times(tm, s, nv, K, na, s.y, 0.0);
    yt_times(tm, s, nv, K, na, s.y, s.w);
    const float t_new = 0.5f * (1.0f + sqrtf(1.0f + 4.0f * tk * tk));
    const float beta = (tk - 1.0f) / t_new;
    for (int r = tid; r < na + s.ne; r += nt) {
      if (r >= na) {
        const int c = 3 * K + (r - na);
        const float fe = s.y[c] - inv_L * (s.w[c] - s.rhs[c]);
        s.y[c] = fe + beta * (fe - s.f[c]);
        s.f[c] = fe;
        continue;
      }
      const int k = s.rows[r];
      float z[3], fn[3];
      for (int j = 0; j < 3; ++j) {
        const int c = j * K + k;
        z[j] = s.y[c] - inv_L * (s.w[c] - s.rhs[c]);
      }
      const float a = s.act[k];
      fn[0] = fmaxf(z[0], 0.0f) * a;
      const float tn = sqrtf(fmaxf(z[1] * z[1] + z[2] * z[2], 1e-18f));
      const float scale = fminf(1.0f, s.mu[k] * fn[0] / fmaxf(tn, 1e-9f)) * a;
      fn[1] = z[1] * scale;
      fn[2] = z[2] * scale;
      for (int j = 0; j < 3; ++j) {
        const int c = j * K + k;
        s.y[c] = fn[j] + beta * (fn[j] - s.f[c]);
        s.f[c] = fn[j];
      }
    }
    tk = t_new;
    tm.sync();
  }
  RS_STAMP(12);
  // ---- velocity: (M + dt D) dv = qfrc_smooth + L (Y f) - D qvel -----------
  y_times(tm, s, nv, K, na, s.f, 0.0);
  for (int i = tid; i < nv; i += nt) {
    double qc = 0.0;
    for (int k = 0; k <= i; ++k) qc += s.L[i * ld + k] * s.acc[k];
    s.b[i] = (double)s.qfrc[i] + qc - (double)s.damp[i] * s.qvel[i];
  }
  tm.sync();
  for (int e = tid; e < nv * nv; e += nt) {
    int i = e / nv, j = e % nv;
    if (j <= i) s.L[i * ld + j] = M[e] + (i == j ? (double)dt * s.damp[i] : 0.0);
  }
  tm.sync();
  chol_team(tm, s.L, nv, ld);
  chol_solve_team(tm, s.L, s.b, nv, ld);
  for (int i = tid; i < nv; i += nt) qvel_out[i] = (float)(s.qvel[i] + (double)dt * s.b[i]);
  tm.sync();
  RS_STAMP(13);
}

// K2's shared memory per scenario: M, Y, then Solve.
RS_HD void carve_k2(int nv, int K, int ne, Carver& c, float*& M, Solve& s) {
  M = c.take(nv * nv);
  s.Y = c.take(y_words(nv, K, ne));
  carve_solve(nv, K, ne, c, s);
}

// K2: one scenario's velocity update from global operands (rows grouped
// [normals (K) | t1 (K) | t2 (K) | equality (s.ne)]).
template <class Team>
RS_DEV void contact_solve_body(const Team& tm, const Solve& s, float* Msh, int b, int nv, int K, int iters,
                               int power_iters, float dt, const float* M, const float* JfT, const float* aref,
                               const float* qfrc, const float* qvel, const float* damping, const float* reg3,
                               const float* mu, const float* active, float* qvel_out, float* f_out) {
  const int tid = tm.rank(), nt = tm.size();
  const int ntot = 3 * K + s.ne;
  for (int i = tid; i < nv * nv; i += nt) Msh[i] = M[(size_t)b * nv * nv + i];
  for (int i = tid; i < nv * ntot; i += nt) s.Y[(i / ntot) * s.ldy + i % ntot] = JfT[(size_t)b * nv * ntot + i];
  for (int c = tid; c < ntot; c += nt) {
    s.aref[c] = aref[(size_t)b * ntot + c];
    s.R[c] = reg3[(size_t)b * ntot + c];
  }
  for (int k = tid; k < K; k += nt) {
    s.mu[k] = mu[(size_t)b * K + k];
    s.act[k] = active[(size_t)b * K + k];
  }
  for (int i = tid; i < nv; i += nt) {
    s.qfrc[i] = qfrc[(size_t)b * nv + i];
    s.qvel[i] = qvel[(size_t)b * nv + i];
    s.damp[i] = damping[(size_t)b * nv + i];
  }
  tm.sync();
  contact_solve_team(tm, s, Msh, nv, K, iters, power_iters, dt, qvel_out + (size_t)b * nv);
  for (int c = tid; c < ntot; c += nt) f_out[(size_t)b * ntot + c] = s.f[c];
}
