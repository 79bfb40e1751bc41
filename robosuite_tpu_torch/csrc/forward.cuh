// Forward products of one scenario, as a team function: FK poses, per-dof
// motion subspace, CRBA mass matrix (with armature) and RNEA bias.
//
// Replaces the forward-products body of the TPU kernels
// (robosuite_tpu/ops/pallas_forward.py forward_lane_body), computing what
// the plain version computes (physics/kinematics.fk, dynamics.crba,
// dynamics.rnea_bias). The tree walk is serial (one lane: each body needs
// its parent's pose); the per-body and per-dof stages spread over the
// team's lanes. Sums over bodies accumulate in double: the
// centroid-referenced RNEA terms cancel, and a float left fold over 26
// bodies loses digits the plain version's pairwise sums keep.
#pragma once

#include "common.cuh"

// One scenario's forward-pass arrays in shared memory (M row-major, row
// stride nv), and the CRBA/RNEA scratch, which is dead once the forward
// pass ends.
struct Fwd {
  float *q, *qd, *arma, *mass, (*inertia)[3], *grav;
  float (*xpos)[3], (*xquat)[4], (*xmat)[9], (*xipos)[3], (*ximat)[9];
  float (*sa)[3], (*sl)[3], *M, *bias;
  float (*Fang)[3], (*Flin)[3], (*sdl)[3], (*sdota)[3], (*sdotl)[3];
  float (*vang)[3], (*vlin)[3], (*fang)[3], (*flin)[3];
};

template <int N>
RS_HD float (*take3(Carver& c, int n))[N] {
  return reinterpret_cast<float(*)[N]>(c.take(N * n));
}

RS_HD void carve_fwd(const RsTables& T, Carver& c, Fwd& f) {
  const int nq = T.nq, nv = T.nv, nb = T.nbody;
  f.q = c.take(nq); f.qd = c.take(nv); f.arma = c.take(nv); f.mass = c.take(nb);
  f.inertia = take3<3>(c, nb); f.grav = c.take(4);
  f.xpos = take3<3>(c, nb); f.xquat = take3<4>(c, nb); f.xmat = take3<9>(c, nb);
  f.xipos = take3<3>(c, nb); f.ximat = take3<9>(c, nb);
  f.sa = take3<3>(c, nv); f.sl = take3<3>(c, nv); f.M = c.take(nv * nv); f.bias = c.take(nv);
}

RS_HD void carve_rnea(const RsTables& T, Carver& c, Fwd& f) {
  const int nv = T.nv, nb = T.nbody;
  f.Fang = take3<3>(c, nv); f.Flin = take3<3>(c, nv); f.sdl = take3<3>(c, nv);
  f.sdota = take3<3>(c, nv); f.sdotl = take3<3>(c, nv);
  f.vang = take3<3>(c, nb); f.vlin = take3<3>(c, nb); f.fang = take3<3>(c, nb); f.flin = take3<3>(c, nb);
}

// Serial tree walk over q (kinematics.fk): body poses into (xpos, xquat)
// and, with SUB, the per-dof motion subspace into (sa, sl). One thread.
// fk_tree is the forward pass's walk; fk_pose the pose-only one, which K4
// runs per scenario and K3's aux tail runs on the integrated qpos.
template <bool SUB>
RS_DEV void fk_walk(const RsTables& T, const float* q, float (*xpos)[3], float (*xquat)[4], float (*sa)[3],
                    float (*sl)[3]) {
  xpos[0][0] = xpos[0][1] = xpos[0][2] = 0.0f;
  xquat[0][0] = 1.0f;
  xquat[0][1] = xquat[0][2] = xquat[0][3] = 0.0f;
  for (int b = 1; b < T.nbody; ++b) {
    int p = T.body_parent[b];
    float pos[3], quat[4], tmp[3];
    quat_rot(xquat[p], T.body_pos[b], tmp);
    for (int i = 0; i < 3; ++i) pos[i] = xpos[p][i] + tmp[i];
    quat_mul(xquat[p], T.body_quat[b], quat);
    for (int j = T.body_jntadr[b]; j < T.body_jntadr[b] + T.body_jntnum[b]; ++j) {
      int qa = T.jnt_qposadr[j], da = T.jnt_dofadr[j];
      int jt = T.jnt_type[j];
      if (jt == RS_FREE) {
        for (int i = 0; i < 3; ++i) pos[i] = q[qa + i];
        float n = sqrtf(q[qa + 3] * q[qa + 3] + q[qa + 4] * q[qa + 4] + q[qa + 5] * q[qa + 5] +
                        q[qa + 6] * q[qa + 6]);
        float inv = 1.0f / fmaxf(n, 1e-8f);
        for (int i = 0; i < 4; ++i) quat[i] = q[qa + 3 + i] * inv;
        if constexpr (SUB) {
          float R[9];
          quat2mat(quat, R);
          for (int i = 0; i < 3; ++i) {
            for (int k = 0; k < 3; ++k) {
              sa[da + i][k] = 0.0f;
              sl[da + i][k] = (i == k) ? 1.0f : 0.0f;
            }
            float a[3] = {R[0 * 3 + i], R[1 * 3 + i], R[2 * 3 + i]};
            for (int k = 0; k < 3; ++k) sa[da + 3 + i][k] = a[k];
            v3_cross(pos, a, sl[da + 3 + i]);
          }
        }
      } else if (jt == RS_BALL) {
        float anchor[3], nq[4], lq[4];
        quat_rot(quat, T.jnt_pos[j], tmp);
        for (int i = 0; i < 3; ++i) anchor[i] = pos[i] + tmp[i];
        float n = sqrtf(q[qa] * q[qa] + q[qa + 1] * q[qa + 1] + q[qa + 2] * q[qa + 2] + q[qa + 3] * q[qa + 3]);
        float inv = 1.0f / fmaxf(n, 1e-8f);
        for (int i = 0; i < 4; ++i) lq[i] = q[qa + i] * inv;
        quat_mul(quat, lq, nq);
        for (int i = 0; i < 4; ++i) quat[i] = nq[i];
        quat_rot(quat, T.jnt_pos[j], tmp);
        for (int i = 0; i < 3; ++i) pos[i] = anchor[i] - tmp[i];
        if constexpr (SUB) {
          float R[9];
          quat2mat(quat, R);
          for (int i = 0; i < 3; ++i) {
            float a[3] = {R[0 * 3 + i], R[1 * 3 + i], R[2 * 3 + i]};
            for (int k = 0; k < 3; ++k) sa[da + i][k] = a[k];
            v3_cross(anchor, a, sl[da + i]);
          }
        }
      } else if (jt == RS_SLIDE) {
        float axis[3];
        quat_rot(quat, T.jnt_axis[j], axis);
        float amt = q[qa] - T.qpos0[qa];
        for (int i = 0; i < 3; ++i) pos[i] += axis[i] * amt;
        if constexpr (SUB) {
          for (int i = 0; i < 3; ++i) {
            sa[da][i] = 0.0f;
            sl[da][i] = axis[i];
          }
        }
      } else {  // hinge
        float axis[3], anchor[3], lq[4], nq[4];
        quat_rot(quat, T.jnt_axis[j], axis);
        quat_rot(quat, T.jnt_pos[j], tmp);
        for (int i = 0; i < 3; ++i) anchor[i] = pos[i] + tmp[i];
        float half = 0.5f * (q[qa] - T.qpos0[qa]);
        float c = cosf(half), sn = sinf(half);
        lq[0] = c;
        for (int i = 0; i < 3; ++i) lq[1 + i] = sn * T.jnt_axis[j][i];
        quat_mul(quat, lq, nq);
        for (int i = 0; i < 4; ++i) quat[i] = nq[i];
        quat_rot(quat, T.jnt_pos[j], tmp);
        for (int i = 0; i < 3; ++i) pos[i] = anchor[i] - tmp[i];
        if constexpr (SUB) {
          for (int i = 0; i < 3; ++i) sa[da][i] = axis[i];
          v3_cross(anchor, axis, sl[da]);
        }
      }
    }
    for (int i = 0; i < 3; ++i) xpos[b][i] = pos[i];
    for (int i = 0; i < 4; ++i) xquat[b][i] = quat[i];
  }
}

RS_DEV void fk_tree(const RsTables& T, const Fwd& s) { fk_walk<true>(T, s.q, s.xpos, s.xquat, s.sa, s.sl); }

RS_DEV void fk_pose(const RsTables& T, const float* q, float (*xpos)[3], float (*xquat)[4]) {
  fk_walk<false>(T, q, xpos, xquat, nullptr, nullptr);
}

// Pose of a frame attached to body b at (lpos, lquat): world position from
// the body's rotation matrix, world rotation from the quaternion product.
RS_DEV void frame_pose(const Fwd& s, int b, const float* lpos, const float* lquat, float* pos, float* mat) {
  const float* R = s.xmat[b];
  for (int i = 0; i < 3; ++i)
    pos[i] = s.xpos[b][i] + (R[i * 3 + 0] * lpos[0] + R[i * 3 + 1] * lpos[1] + R[i * 3 + 2] * lpos[2]);
  float q[4];
  quat_mul(s.xquat[b], lquat, q);
  quat2mat(q, mat);
}

// I_C x with I_C = R diag(I) R^T (inertia about the COM, world frame)
RS_DEV void inertia_mul(const Fwd& s, int b, const double* x, double* out) {
  const float* R = s.ximat[b];
  double l[3];
  for (int k = 0; k < 3; ++k)
    l[k] = (double)s.inertia[b][k] * (R[0 * 3 + k] * x[0] + R[1 * 3 + k] * x[1] + R[2 * 3 + k] * x[2]);
  for (int i = 0; i < 3; ++i) out[i] = R[i * 3 + 0] * l[0] + R[i * 3 + 1] * l[1] + R[i * 3 + 2] * l[2];
}

RS_DEV void d3_cross(const double* a, const double* b, double* o) {
  double x = a[1] * b[2] - a[2] * b[1];
  double y = a[2] * b[0] - a[0] * b[2];
  double z = a[0] * b[1] - a[1] * b[0];
  o[0] = x; o[1] = y; o[2] = z;
}

// The whole forward pass. Expects s.q, s.qd, s.mass, s.inertia, s.grav,
// s.arma loaded and the team synchronised; ends synchronised.
template <class Team>
RS_DEV void forward_team(const Team& tm, const RsTables& T, const Fwd& s) {
  const int tid = tm.rank(), nt = tm.size();
  const int nb = T.nbody, nv = T.nv;
  if (tid == 0) fk_tree(T, s);
  tm.sync();
  RS_STAMP(2);
  for (int b = tid; b < nb; b += nt) {
    quat2mat(s.xquat[b], s.xmat[b]);
    const float* R = s.xmat[b];
    for (int i = 0; i < 3; ++i)
      s.xipos[b][i] = s.xpos[b][i] + (R[i * 3] * T.body_ipos[b][0] + R[i * 3 + 1] * T.body_ipos[b][1] +
                                      R[i * 3 + 2] * T.body_ipos[b][2]);
    float qi[4];
    quat_mul(s.xquat[b], T.body_iquat[b], qi);
    quat2mat(qi, s.ximat[b]);
  }
  tm.sync();
  RS_STAMP(3);

  // ---- CRBA: composite momentum of every dof's subtree, column-anchored
  for (int d = tid; d < nv; d += nt) {
    const float* pd = s.xpos[T.dof_bodyid[d]];
    double sa[3], slp[3], p[3];
    for (int i = 0; i < 3; ++i) { sa[i] = s.sa[d][i]; p[i] = pd[i]; }
    d3_cross(sa, p, slp);
    for (int i = 0; i < 3; ++i) slp[i] += s.sl[d][i];
    double Fa[3] = {0, 0, 0}, Fl[3] = {0, 0, 0};
    for (int b = 0; b < nb; ++b) {
      if (T.anc[b][d] == 0.0f) continue;
      double r[3], v[3], fl[3], fa[3], t[3];
      for (int i = 0; i < 3; ++i) r[i] = (double)s.xipos[b][i] - p[i];
      d3_cross(sa, r, v);
      for (int i = 0; i < 3; ++i) fl[i] = s.mass[b] * (slp[i] + v[i]);
      inertia_mul(s, b, sa, fa);
      d3_cross(r, fl, t);
      for (int i = 0; i < 3; ++i) { Fa[i] += fa[i] + t[i]; Fl[i] += fl[i]; }
    }
    for (int i = 0; i < 3; ++i) { s.Fang[d][i] = (float)Fa[i]; s.Flin[d][i] = (float)Fl[i]; }
  }
  // ---- RNEA (a): mass centroid, on every lane (a short sum kept in registers)
  float o[3];
  {
    double ms = 0, mo[3] = {0, 0, 0};
    for (int b = 0; b < nb; ++b) {
      ms += s.mass[b];
      for (int i = 0; i < 3; ++i) mo[i] += (double)s.mass[b] * s.xipos[b][i];
    }
    for (int i = 0; i < 3; ++i) o[i] = (float)(mo[i] / ms);
  }
  tm.sync();
  RS_STAMP(4);

  // M[e][d] = ang_e . F_ang_d + lin_e(p_d) . F_lin_d where e moves body(d);
  // the symmetric entry otherwise; armature on the diagonal.
  for (int idx = tid; idx < nv * nv; idx += nt) {
    int e = idx / nv, d = idx % nv;
    int col = -1, row = -1;
    if (T.anc[T.dof_bodyid[d]][e] != 0.0f) { row = e; col = d; }
    else if (T.anc[T.dof_bodyid[e]][d] != 0.0f) { row = d; col = e; }
    double v = 0.0;
    if (col >= 0) {
      const float* pd = s.xpos[T.dof_bodyid[col]];
      double sa[3], p[3], lin[3];
      for (int i = 0; i < 3; ++i) { sa[i] = s.sa[row][i]; p[i] = pd[i]; }
      d3_cross(sa, p, lin);
      for (int i = 0; i < 3; ++i) {
        lin[i] += s.sl[row][i];
        v += sa[i] * s.Fang[col][i] + lin[i] * s.Flin[col][i];
      }
    }
    if (e == d) v += s.arma[d];
    s.M[e * nv + d] = (float)v;
  }
  // ---- RNEA (b): centroid-referenced linear subspace
  for (int d = tid; d < nv; d += nt) {
    v3_cross(s.sa[d], o, s.sdl[d]);
    for (int i = 0; i < 3; ++i) s.sdl[d][i] += s.sl[d][i];
  }
  tm.sync();
  // (c) body velocities
  for (int b = tid; b < nb; b += nt) {
    double va[3] = {0, 0, 0}, vl[3] = {0, 0, 0};
    for (int d = 0; d < nv; ++d) {
      if (T.anc[b][d] == 0.0f) continue;
      for (int i = 0; i < 3; ++i) { va[i] += (double)s.qd[d] * s.sa[d][i]; vl[i] += (double)s.qd[d] * s.sdl[d][i]; }
    }
    for (int i = 0; i < 3; ++i) { s.vang[b][i] = (float)va[i]; s.vlin[b][i] = (float)vl[i]; }
  }
  tm.sync();
  // (d) motion-subspace rates; world-fixed free translation axes have none
  for (int d = tid; d < nv; d += nt) {
    int bd = T.dof_bodyid[d];
    if (T.dof_free_trans[d]) {
      for (int i = 0; i < 3; ++i) s.sdota[d][i] = s.sdotl[d][i] = 0.0f;
      continue;
    }
    float t1[3], t2[3];
    v3_cross(s.vang[bd], s.sa[d], s.sdota[d]);
    v3_cross(s.vang[bd], s.sdl[d], t1);
    v3_cross(s.vlin[bd], s.sa[d], t2);
    for (int i = 0; i < 3; ++i) s.sdotl[d][i] = t1[i] + t2[i];
  }
  tm.sync();
  // (e) per-body force f = I a + v x* (I v), about the centroid
  for (int b = tid; b < nb; b += nt) {
    double aa[3] = {0, 0, 0}, al[3] = {0, 0, 0};
    for (int d = 0; d < nv; ++d) {
      if (T.anc[b][d] == 0.0f) continue;
      for (int i = 0; i < 3; ++i) { aa[i] += (double)s.qd[d] * s.sdota[d][i]; al[i] += (double)s.qd[d] * s.sdotl[d][i]; }
    }
    for (int i = 0; i < 3; ++i) al[i] -= s.grav[i];
    double m = s.mass[b], c[3], h[3], va[3], vl[3];
    for (int i = 0; i < 3; ++i) {
      c[i] = (double)s.xipos[b][i] - o[i];
      h[i] = m * c[i];
      va[i] = s.vang[b][i];
      vl[i] = s.vlin[b][i];
    }
    double c2 = c[0] * c[0] + c[1] * c[1] + c[2] * c[2];
    // imul(x_ang, x_lin) -> (I_O x_ang + h x x_lin, m x_lin + x_ang x h)
    double Ia_a[3], Ia_l[3], Iv_a[3], Iv_l[3];
    const double* xs[2][2] = {{aa, al}, {va, vl}};
    double* outs[2][2] = {{Ia_a, Ia_l}, {Iv_a, Iv_l}};
    for (int k = 0; k < 2; ++k) {
      const double* xa = xs[k][0];
      const double* xl = xs[k][1];
      double ic[3], t[3];
      inertia_mul(s, b, xa, ic);
      double cx = c[0] * xa[0] + c[1] * xa[1] + c[2] * xa[2];
      d3_cross(h, xl, t);
      for (int i = 0; i < 3; ++i) outs[k][0][i] = ic[i] + m * (c2 * xa[i] - c[i] * cx) + t[i];
      d3_cross(xa, h, t);
      for (int i = 0; i < 3; ++i) outs[k][1][i] = m * xl[i] + t[i];
    }
    double t1[3], t2[3], t3[3];
    d3_cross(va, Iv_a, t1);
    d3_cross(vl, Iv_l, t2);
    d3_cross(va, Iv_l, t3);
    for (int i = 0; i < 3; ++i) {
      s.fang[b][i] = (float)(Ia_a[i] + t1[i] + t2[i]);
      s.flin[b][i] = (float)(Ia_l[i] + t3[i]);
    }
  }
  tm.sync();
  // (f) subtree force sums projected on the subspace
  for (int d = tid; d < nv; d += nt) {
    int bd = T.dof_bodyid[d];
    double fa[3] = {0, 0, 0}, fl[3] = {0, 0, 0};
    for (int b2 = 0; b2 < nb; ++b2) {
      if (!((T.body_desc[bd] >> b2) & 1u)) continue;
      for (int i = 0; i < 3; ++i) { fa[i] += s.fang[b2][i]; fl[i] += s.flin[b2][i]; }
    }
    double v = 0.0;
    for (int i = 0; i < 3; ++i) v += s.sa[d][i] * fa[i] + s.sdl[d][i] * fl[i];
    s.bias[d] = (float)v;
  }
  tm.sync();
  RS_STAMP(5);
}

// K1: one scenario's forward products from global inputs to global outputs.
template <class Team>
RS_DEV void forward_body(const Team& tm, const RsTables& T, const Fwd& s, int b, const float* qpos, const float* qvel,
                         const float* mass, const float* inertia, const float* gravity, const float* armature,
                         float* xpos, float* xquat, float* xmat, float* gxpos, float* gxmat, float* sxpos,
                         float* sxmat, float* sdof_ang, float* sdof_lin, float* M, float* bias, float* xipos,
                         float* ximat) {
  const int tid = tm.rank(), nt = tm.size();
  const int nq = T.nq, nv = T.nv, nb = T.nbody, ng = T.ngeom, ns = T.nsite;
  for (int i = tid; i < nq; i += nt) s.q[i] = qpos[(size_t)b * nq + i];
  for (int i = tid; i < nv; i += nt) { s.qd[i] = qvel[(size_t)b * nv + i]; s.arma[i] = armature[(size_t)b * nv + i]; }
  for (int i = tid; i < nb; i += nt) {
    s.mass[i] = mass[(size_t)b * nb + i];
    for (int k = 0; k < 3; ++k) s.inertia[i][k] = inertia[((size_t)b * nb + i) * 3 + k];
  }
  for (int i = tid; i < 3; i += nt) s.grav[i] = gravity[(size_t)b * 3 + i];
  tm.sync();
  forward_team(tm, T, s);
  for (int i = tid; i < nb; i += nt) {
    size_t o = (size_t)b * nb + i;
    for (int k = 0; k < 3; ++k) {
      xpos[o * 3 + k] = s.xpos[i][k];
      xipos[o * 3 + k] = s.xipos[i][k];
    }
    for (int k = 0; k < 4; ++k) xquat[o * 4 + k] = s.xquat[i][k];
    for (int k = 0; k < 9; ++k) {
      xmat[o * 9 + k] = s.xmat[i][k];
      ximat[o * 9 + k] = s.ximat[i][k];
    }
  }
  for (int g = tid; g < ng; g += nt) {
    size_t o = (size_t)b * ng + g;
    frame_pose(s, T.geom_bodyid[g], T.geom_pos[g], T.geom_quat[g], gxpos + o * 3, gxmat + o * 9);
  }
  for (int g = tid; g < ns; g += nt) {
    size_t o = (size_t)b * ns + g;
    frame_pose(s, T.site_bodyid[g], T.site_pos[g], T.site_quat[g], sxpos + o * 3, sxmat + o * 9);
  }
  for (int d = tid; d < nv; d += nt) {
    size_t o = (size_t)b * nv + d;
    for (int k = 0; k < 3; ++k) {
      sdof_ang[o * 3 + k] = s.sa[d][k];
      sdof_lin[o * 3 + k] = s.sl[d][k];
    }
    bias[o] = s.bias[d];
  }
  for (int i = tid; i < nv * nv; i += nt) M[(size_t)b * nv * nv + i] = s.M[i];
}

// K4: one scenario's pose-only FK, on one thread, in its own (local) arrays.
RS_DEV void fk_pose_one(const RsTables& T, size_t b, const float* qpos, float* xpos, float* xquat) {
  const int nq = T.nq, nb = T.nbody;
  float q[RS_MAXQ], xp[RS_MAXB][3], xq[RS_MAXB][4];
  for (int i = 0; i < nq; ++i) q[i] = qpos[b * nq + i];
  fk_pose(T, q, xp, xq);
  for (int i = 0; i < nb; ++i) {
    for (int k = 0; k < 3; ++k) xpos[(b * nb + i) * 3 + k] = xp[i][k];
    for (int k = 0; k < 4; ++k) xquat[(b * nb + i) * 4 + k] = xq[i][k];
  }
}
