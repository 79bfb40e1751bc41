// Forward products of one scenario, as a team function: FK poses, per-dof
// motion subspace, CRBA mass matrix (with armature) and RNEA bias; and the
// block-level parts of K1 and K4 (staged inputs, block-contiguous output
// spans).
//
// Replaces the forward-products body of the TPU kernels
// (robosuite_tpu/ops/pallas_forward.py forward_lane_body), computing what
// the plain version computes (physics/kinematics.fk, dynamics.crba,
// dynamics.rnea_bias). The tree walk splits in two: each joint's terms
// that do not depend on its parent's pose (the hinge's half-angle
// quaternion, the normalised ball or free quaternion, the slide amount)
// come first, one joint a lane (joint_terms); then one lane composes the
// chain (fk_walk), each body's step a few quaternion products on its
// parent's pose, carried in registers down a chain. The composition keeps
// the arithmetic of a plain walk operand for operand, so the poses do not
// depend on the split. CRBA and RNEA run over the (body, dof) pairs with
// anc != 0 (the table's pair lists): the per-pair CRBA terms spread over
// the lanes, and every sum runs over one dof's or one body's run of the
// list in the list's order, which is the order of a plain loop, so it does
// not depend on how the lanes split the pairs. Sums over bodies accumulate
// in double: the centroid-referenced RNEA terms cancel, and a float left
// fold over 26 bodies loses digits the plain version's pairwise sums keep.
#pragma once

#include "common.cuh"

// One scenario's forward-pass arrays in shared memory (M row-major, row
// stride nv), and its scratch (carve_rnea), dead once the pass ends.
struct Fwd {
  float *q, *qd, *arma, *mass, (*inertia)[3], *grav;
  float (*xpos)[3], (*xquat)[4], (*xmat)[9], (*xipos)[3], (*ximat)[9];
  float (*sa)[3], (*sl)[3], *M, *bias;
  float (*Fang)[3], (*Flin)[3];  // CRBA's per-dof composite momenta
  float (*jl)[4];                // the walk's joint terms
  double (*pc)[6];               // CRBA's per-pair terms
  float (*sdl)[3], (*sdota)[3], (*sdotl)[3], (*vang)[3], (*vlin)[3], (*fang)[3], (*flin)[3];
};

template <int N>
RS_HD float (*take3(Carver& c, int n, int align = 1))[N] {
  return reinterpret_cast<float(*)[N]>(c.take(N * n, align));
}

// The model rows the forward pass reads, as a compact image carved from
// the model's own sizes: K1 and K4 stage it in shared memory once a block
// (one contiguous span copy), so the serial walk and the pair loops wait on
// shared loads, not on dependent global ones. Its members carry the names
// of RsTables', so the team functions below read either (K3 reads the
// table in global memory). The walk's rows come first: K4 stages only
// those (walk_words).
struct FwdTab {
  int nq, nv, nbody, njnt, ngeom, nsite, npr, walk_words;
  const int *body_parent, *body_jntadr, *body_jntnum, *jnt_type, *jnt_qposadr, *jnt_dofadr;
  const float (*body_pos)[3], (*body_quat)[4], (*jnt_pos)[3], (*jnt_axis)[3], *qpos0;
  const float (*body_ipos)[3], (*body_iquat)[4];
  const int *dof_bodyid, *dof_free_trans, *pr_db, *dof_pr0, *pr_bd, *body_pr0, *m_rc;
  const int *geom_bodyid, *site_bodyid;
  const float (*geom_pos)[3], (*geom_quat)[4], (*site_pos)[3], (*site_quat)[4];
};

// One region of the image: dst points at it, and with `fill` (the host,
// building the image) src's words are copied in.
template <class P>
RS_HD void tab_take(Carver& c, P& dst, const void* src, int words, bool fill) {
  float* p = c.take(words);
  dst = reinterpret_cast<P>(p);
  if (fill)
    for (int i = 0; i < words; ++i)
      reinterpret_cast<uint32_t*>(p)[i] = reinterpret_cast<const uint32_t*>(src)[i];
}

// The image's layout from T's sizes (its regions one after another from
// c), and with `fill` its contents from T.
RS_HD void carve_tab(const RsTables& T, Carver& c, FwdTab& F, bool fill = false) {
  const int nb = T.nbody, nj = T.njnt, nv = T.nv, ng = T.ngeom, ns = T.nsite;
  F.nq = T.nq; F.nv = nv; F.nbody = nb; F.njnt = nj; F.ngeom = ng; F.nsite = ns; F.npr = T.npr;
  const int w0 = c.w;
  tab_take(c, F.body_parent, T.body_parent, nb, fill);
  tab_take(c, F.body_jntadr, T.body_jntadr, nb, fill);
  tab_take(c, F.body_jntnum, T.body_jntnum, nb, fill);
  tab_take(c, F.jnt_type, T.jnt_type, nj, fill);
  tab_take(c, F.jnt_qposadr, T.jnt_qposadr, nj, fill);
  tab_take(c, F.jnt_dofadr, T.jnt_dofadr, nj, fill);
  tab_take(c, F.body_pos, T.body_pos, 3 * nb, fill);
  tab_take(c, F.body_quat, T.body_quat, 4 * nb, fill);
  tab_take(c, F.jnt_pos, T.jnt_pos, 3 * nj, fill);
  tab_take(c, F.jnt_axis, T.jnt_axis, 3 * nj, fill);
  tab_take(c, F.qpos0, T.qpos0, T.nq, fill);
  F.walk_words = c.w - w0;
  tab_take(c, F.body_ipos, T.body_ipos, 3 * nb, fill);
  tab_take(c, F.body_iquat, T.body_iquat, 4 * nb, fill);
  tab_take(c, F.dof_bodyid, T.dof_bodyid, nv, fill);
  tab_take(c, F.dof_free_trans, T.dof_free_trans, nv, fill);
  tab_take(c, F.pr_db, T.pr_db, T.npr, fill);
  tab_take(c, F.dof_pr0, T.dof_pr0, nv + 1, fill);
  tab_take(c, F.pr_bd, T.pr_bd, T.npr, fill);
  tab_take(c, F.body_pr0, T.body_pr0, nb + 1, fill);
  tab_take(c, F.m_rc, T.m_rc, nv * nv, fill);
  tab_take(c, F.geom_bodyid, T.geom_bodyid, ng, fill);
  tab_take(c, F.site_bodyid, T.site_bodyid, ns, fill);
  tab_take(c, F.geom_pos, T.geom_pos, 3 * ng, fill);
  tab_take(c, F.geom_quat, T.geom_quat, 4 * ng, fill);
  tab_take(c, F.site_pos, T.site_pos, 3 * ns, fill);
  tab_take(c, F.site_quat, T.site_quat, 4 * ns, fill);
  c.w = (c.w + 3) / 4 * 4;
}

// The image of T into out (a null out only counts); -> its words.
RS_HD int forward_tab_image(const RsTables& T, float* out) {
  Carver c{out, 0};
  FwdTab F;
  carve_tab(T, c, F, out != nullptr);
  return c.w;
}

// The inputs and the outputs of the pass; `al` aligns each region (K1
// aligns to 4 words, so a block's spans move 16 bytes a lane).
RS_HD void carve_fwd(const RsTables& T, Carver& c, Fwd& f, int al = 1) {
  const int nq = T.nq, nv = T.nv, nb = T.nbody;
  f.q = c.take(nq, al); f.qd = c.take(nv, al); f.arma = c.take(nv, al); f.mass = c.take(nb, al);
  f.inertia = take3<3>(c, nb, al); f.grav = c.take(4, al);
  f.xpos = take3<3>(c, nb, al); f.xquat = take3<4>(c, nb, al); f.xmat = take3<9>(c, nb, al);
  f.xipos = take3<3>(c, nb, al); f.ximat = take3<9>(c, nb, al);
  f.sa = take3<3>(c, nv, al); f.sl = take3<3>(c, nv, al); f.M = c.take(nv * nv, al); f.bias = c.take(nv, al);
}

// The scratch: CRBA's per-dof sums, then one union of regions live at
// different times: the joint terms (the walk), the per-pair terms (CRBA)
// and RNEA's arrays.
RS_HD void carve_rnea(const RsTables& T, Carver& c, Fwd& f) {
  const int nv = T.nv, nb = T.nbody;
  f.Fang = take3<3>(c, nv); f.Flin = take3<3>(c, nv);
  Carver cj = c, cp = c;
  f.jl = take3<4>(cj, T.njnt);
  f.pc = reinterpret_cast<double(*)[6]>(cp.take_d(6 * T.npr));
  f.sdl = take3<3>(c, nv); f.sdota = take3<3>(c, nv); f.sdotl = take3<3>(c, nv);
  f.vang = take3<3>(c, nb); f.vlin = take3<3>(c, nb); f.fang = take3<3>(c, nb); f.flin = take3<3>(c, nb);
  c.w = c.w > cj.w ? c.w : cj.w;
  c.w = c.w > cp.w ? c.w : cp.w;
}

// The terms of joint j that do not depend on its parent's pose, from q
// (element i at q[i * qs]) into out (element k at out[k * os]): a hinge's
// half-angle quaternion about its axis, a ball's or free joint's
// normalised quaternion, a slide's displacement.
template <class Tab>
RS_DEV void joint_terms(const Tab& T, int j, const float* q, int qs, float* out, int os) {
  const int qa = T.jnt_qposadr[j], jt = T.jnt_type[j];
  if (jt == RS_FREE || jt == RS_BALL) {
    const int a = jt == RS_FREE ? qa + 3 : qa;
    const float v0 = q[a * qs], v1 = q[(a + 1) * qs], v2 = q[(a + 2) * qs], v3 = q[(a + 3) * qs];
    float n = sqrtf(v0 * v0 + v1 * v1 + v2 * v2 + v3 * v3);
    float inv = 1.0f / fmaxf(n, 1e-8f);
    out[0] = v0 * inv; out[os] = v1 * inv; out[2 * os] = v2 * inv; out[3 * os] = v3 * inv;
  } else if (jt == RS_SLIDE) {
    out[0] = q[qa * qs] - T.qpos0[qa];
  } else {  // hinge
    float half = 0.5f * (q[qa * qs] - T.qpos0[qa]);
    float c = cosf(half), sn = sinf(half);
    out[0] = c;
    for (int i = 0; i < 3; ++i) out[(1 + i) * os] = sn * T.jnt_axis[j][i];
  }
}

// The serial composition of the tree walk (kinematics.fk) on one thread:
// body poses into (xp, xq) (body b's component i at xp[(3 b + i) ps],
// xq[(4 b + i) ps]) and, with SUB, the per-dof motion subspace into (sa,
// sl), from q and the joint terms jl (joint j's term k at jl[(4 j + k)
// js]). Only the parent-dependent rotations and products remain here; a
// body whose parent is the body before it takes the parent's pose from
// registers. K1 and K3 run it on one lane of a scenario's team (strides
// 1), K4 on one thread per scenario over scenario-minor arrays.
template <bool SUB, class Tab>
RS_DEV void fk_walk(const Tab& T, const float* q, int qs, const float* jl, int js, float* xp, float* xq, int ps,
                    float (*sa)[3], float (*sl)[3]) {
  float ppos[3] = {0.0f, 0.0f, 0.0f}, pquat[4] = {1.0f, 0.0f, 0.0f, 0.0f};  // body b - 1's pose
  for (int i = 0; i < 3; ++i) xp[i * ps] = ppos[i];
  for (int i = 0; i < 4; ++i) xq[i * ps] = pquat[i];
  for (int b = 1; b < T.nbody; ++b) {
    const int p = T.body_parent[b];
    if (p != b - 1) {
      for (int i = 0; i < 3; ++i) ppos[i] = xp[(3 * p + i) * ps];
      for (int i = 0; i < 4; ++i) pquat[i] = xq[(4 * p + i) * ps];
    }
    float pos[3], quat[4], tmp[3];
    quat_rot(pquat, T.body_pos[b], tmp);
    for (int i = 0; i < 3; ++i) pos[i] = ppos[i] + tmp[i];
    quat_mul(pquat, T.body_quat[b], quat);
    for (int j = T.body_jntadr[b]; j < T.body_jntadr[b] + T.body_jntnum[b]; ++j) {
      const int qa = T.jnt_qposadr[j], jt = T.jnt_type[j];
      float lq[4];
      for (int i = 0; i < 4; ++i) lq[i] = jl[(4 * j + i) * js];
      if (jt == RS_FREE) {
        for (int i = 0; i < 3; ++i) pos[i] = q[(qa + i) * qs];
        for (int i = 0; i < 4; ++i) quat[i] = lq[i];
        if constexpr (SUB) {
          const int da = T.jnt_dofadr[j];
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
        float anchor[3], nq[4];
        quat_rot(quat, T.jnt_pos[j], tmp);
        for (int i = 0; i < 3; ++i) anchor[i] = pos[i] + tmp[i];
        quat_mul(quat, lq, nq);
        for (int i = 0; i < 4; ++i) quat[i] = nq[i];
        quat_rot(quat, T.jnt_pos[j], tmp);
        for (int i = 0; i < 3; ++i) pos[i] = anchor[i] - tmp[i];
        if constexpr (SUB) {
          const int da = T.jnt_dofadr[j];
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
        float amt = lq[0];
        for (int i = 0; i < 3; ++i) pos[i] += axis[i] * amt;
        if constexpr (SUB) {
          const int da = T.jnt_dofadr[j];
          for (int i = 0; i < 3; ++i) {
            sa[da][i] = 0.0f;
            sl[da][i] = axis[i];
          }
        }
      } else {  // hinge
        float axis[3], anchor[3], nq[4];
        quat_rot(quat, T.jnt_axis[j], axis);
        quat_rot(quat, T.jnt_pos[j], tmp);
        for (int i = 0; i < 3; ++i) anchor[i] = pos[i] + tmp[i];
        quat_mul(quat, lq, nq);
        for (int i = 0; i < 4; ++i) quat[i] = nq[i];
        quat_rot(quat, T.jnt_pos[j], tmp);
        for (int i = 0; i < 3; ++i) pos[i] = anchor[i] - tmp[i];
        if constexpr (SUB) {
          const int da = T.jnt_dofadr[j];
          for (int i = 0; i < 3; ++i) sa[da][i] = axis[i];
          v3_cross(anchor, axis, sl[da]);
        }
      }
    }
    for (int i = 0; i < 3; ++i) xp[(3 * b + i) * ps] = ppos[i] = pos[i];
    for (int i = 0; i < 4; ++i) xq[(4 * b + i) * ps] = pquat[i] = quat[i];
  }
}

// The walk of one scenario over its team: the joint terms of q one joint
// a lane, then the composition on lane 0 (with SUB, also the motion
// subspace). Ends synchronised.
template <bool SUB, class Team, class Tab>
RS_DEV void walk_team(const Team& tm, const Tab& T, const float* q, const Fwd& s) {
  for (int j = tm.rank(); j < T.njnt; j += tm.size()) joint_terms(T, j, q, 1, s.jl[j], 1);
  tm.sync();
  if (tm.rank() == 0) fk_walk<SUB>(T, q, 1, &s.jl[0][0], 1, &s.xpos[0][0], &s.xquat[0][0], 1, s.sa, s.sl);
  tm.sync();
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
template <class Team, class Tab>
RS_DEV void forward_team(const Team& tm, const Tab& T, const Fwd& s) {
  const int tid = tm.rank(), nt = tm.size();
  const int nb = T.nbody, nv = T.nv;
  walk_team<true>(tm, T, s.q, s);
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

  // ---- CRBA: each (body, dof) pair's share of the dof's composite
  // momentum, column-anchored, one pair a lane ...
  for (int k = tid; k < T.npr; k += nt) {
    const int b = T.pr_db[k] >> 8, d = T.pr_db[k] & 255;
    const float* pd = s.xpos[T.dof_bodyid[d]];
    double sa[3], slp[3], p[3];
    for (int i = 0; i < 3; ++i) { sa[i] = s.sa[d][i]; p[i] = pd[i]; }
    d3_cross(sa, p, slp);
    for (int i = 0; i < 3; ++i) slp[i] += s.sl[d][i];
    double r[3], v[3], fl[3], fa[3], t[3];
    for (int i = 0; i < 3; ++i) r[i] = (double)s.xipos[b][i] - p[i];
    d3_cross(sa, r, v);
    for (int i = 0; i < 3; ++i) fl[i] = s.mass[b] * (slp[i] + v[i]);
    inertia_mul(s, b, sa, fa);
    d3_cross(r, fl, t);
    for (int i = 0; i < 3; ++i) { s.pc[k][i] = fa[i] + t[i]; s.pc[k][3 + i] = fl[i]; }
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
  // ... summed per dof over its run of pairs, bodies in ascending order
  for (int d = tid; d < nv; d += nt) {
    double Fa[3] = {0, 0, 0}, Fl[3] = {0, 0, 0};
    for (int k = T.dof_pr0[d]; k < T.dof_pr0[d + 1]; ++k)
      for (int i = 0; i < 3; ++i) { Fa[i] += s.pc[k][i]; Fl[i] += s.pc[k][3 + i]; }
    for (int i = 0; i < 3; ++i) { s.Fang[d][i] = (float)Fa[i]; s.Flin[d][i] = (float)Fl[i]; }
  }
  tm.sync();
  RS_STAMP(4);

  // M[e][d] = ang_e . F_ang_d + lin_e(p_d) . F_lin_d where e moves body(d);
  // the symmetric entry otherwise; armature on the diagonal.
  for (int idx = tid; idx < nv * nv; idx += nt) {
    const int e = idx / nv, d = idx - e * nv, rc = T.m_rc[idx];
    const int row = rc >> 8, col = rc & 255;
    double v = 0.0;
    if (rc >= 0) {
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
  // (c) body velocities, over each body's run of dofs
  for (int b = tid; b < nb; b += nt) {
    double va[3] = {0, 0, 0}, vl[3] = {0, 0, 0};
    for (int k = T.body_pr0[b]; k < T.body_pr0[b + 1]; ++k) {
      const int d = T.pr_bd[k];
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
    for (int k = T.body_pr0[b]; k < T.body_pr0[b + 1]; ++k) {
      const int d = T.pr_bd[k];
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
  // (f) subtree force sums over each dof's run of bodies, projected on the subspace
  for (int d = tid; d < nv; d += nt) {
    double fa[3] = {0, 0, 0}, fl[3] = {0, 0, 0};
    for (int k = T.dof_pr0[d]; k < T.dof_pr0[d + 1]; ++k) {
      const int b2 = T.pr_db[k] >> 8;
      for (int i = 0; i < 3; ++i) { fa[i] += s.fang[b2][i]; fl[i] += s.flin[b2][i]; }
    }
    double v = 0.0;
    for (int i = 0; i < 3; ++i) v += s.sa[d][i] * fa[i] + s.sdl[d][i] * fl[i];
    s.bias[d] = (float)v;
  }
  tm.sync();
  RS_STAMP(5);
}

// ---- K1's block ------------------------------------------------------------
//
// A block holds S scenarios (one team each). Its shared memory is carved
// region by region for all S at once (carve_k1), so each input's and each
// output's chunks for the block lie back to back: the block loads its
// inputs and stores its outputs as contiguous spans, consecutive threads
// on consecutive addresses.

// The geom and site frame poses, staged for the block's store.
struct Frames {
  float (*gxpos)[3], (*gxmat)[9], (*sxpos)[3], (*sxmat)[9];
};

// K1's shared memory: the model image (once a block, F), then S
// scenarios' regions, scenario s's pointers into (f, fr); -> the block's
// words. The frames share the scratch's place: they are computed once the
// pass has ended.
RS_HD int carve_k1(const RsTables& T, float* base, int S, int s, FwdTab& F, Fwd& f, Frames& fr) {
  Carver ct{base, 0};
  carve_tab(T, ct, F);
  Carver c{base, ct.w, S, s};
  carve_fwd(T, c, f, 4);
  const int u0 = (c.w + 3) / 4 * 4;
  Carver cr{base, u0, S, s}, cf{base, u0, S, s};
  carve_rnea(T, cr, f);
  fr.gxpos = take3<3>(cf, T.ngeom, 4); fr.gxmat = take3<9>(cf, T.ngeom, 4);
  fr.sxpos = take3<3>(cf, T.nsite, 4); fr.sxmat = take3<9>(cf, T.nsite, 4);
  const int w = cr.w > cf.w ? cr.w : cf.w;
  return (w + 3) / 4 * 4;
}

// K1's 13 outputs, in the order of the one allocation: xpos, xquat, xmat,
// geom_xpos, geom_xmat, site_xpos, site_xmat, sdof_ang, sdof_lin, M, bias,
// xipos, ximat. Words per scenario of each into n; the allocation holds
// output k's (B, n[k]) block at k1_offset(n, k, B), 4-word aligned.
#define RS_K1_NOUT 13
template <class Tab>
RS_HD void k1_sizes(const Tab& T, int* n) {
  const int nb = T.nbody, ng = T.ngeom, ns = T.nsite, nv = T.nv;
  const int w[RS_K1_NOUT] = {3 * nb, 4 * nb, 9 * nb, 3 * ng, 9 * ng, 3 * ns, 9 * ns, 3 * nv, 3 * nv, nv * nv, nv,
                             3 * nb, 9 * nb};
  for (int k = 0; k < RS_K1_NOUT; ++k) n[k] = w[k];
}

RS_HD size_t k1_offset(const int* n, int k, size_t B) {
  size_t o = 0;
  for (int i = 0; i < k; ++i) o += (B * n[i] + 3) / 4 * 4;
  return o;
}

// dst[s * dn + i] = src[s * ss + i] for i < n, s < nS over the block's
// threads (ss = 0: one row for every scenario); a contiguous span when dn
// == ss == n, 16 bytes a thread where both ends are aligned.
template <class Blk>
RS_DEV void load_rows(const Blk& bk, float* dst, int dn, const float* src, size_t ss, int n, int nS) {
  const int tid = bk.rank(), nt = bk.size();
  if (dn == n && ss == (size_t)n) {
    const int total = n * nS;
    int head = 0;
    if (((uintptr_t)dst & 15) == 0 && ((uintptr_t)src & 15) == 0) {
      head = total / 4 * 4;
      for (int e = 4 * tid; e < head; e += 4 * nt)
        *reinterpret_cast<float4*>(dst + e) = *reinterpret_cast<const float4*>(src + e);
    }
    for (int e = head + tid; e < total; e += nt) dst[e] = src[e];
    return;
  }
  const int ds = nt / n, di = nt - ds * n;
  for (int e = tid, s = tid / n, i = tid - s * n; e < n * nS; e += nt) {
    dst[s * dn + i] = src[s * ss + i];
    s += ds;
    i += di;
    if (i >= n) { i -= n; ++s; }
  }
}

// A block's output span: nw words from shared src to global dst, by
// consecutive threads, 16 bytes a thread where both ends are aligned.
template <class Blk>
RS_DEV void store_span(const Blk& bk, float* dst, const float* src, int nw) {
  const int tid = bk.rank(), nt = bk.size();
  int head = 0;
  if (((uintptr_t)dst & 15) == 0 && ((uintptr_t)src & 15) == 0) {
    head = nw / 4 * 4;
    for (int e = 4 * tid; e < head; e += 4 * nt)
      *reinterpret_cast<float4*>(dst + e) = *reinterpret_cast<const float4*>(src + e);
  }
  for (int e = head + tid; e < nw; e += nt) dst[e] = src[e];
}

// K1's global operands: the inputs (the leaves with a batch stride each, 0
// for one row shared by every scenario) and the one output allocation.
struct K1Io {
  const float *qpos, *qvel, *mass, *inertia, *gravity, *armature;
  int mass_bs, inertia_bs, gravity_bs, armature_bs;
  float* out;
};

// The block's inputs, scenarios b0 .. b0 + nS, into the regions of f0
// (scenario 0's pointers, the regions' starts). Ends unsynchronised.
template <class Blk, class Tab>
RS_DEV void k1_load(const Blk& bk, const Tab& T, const Fwd& f0, size_t b0, int nS, const K1Io& io) {
  const int nq = T.nq, nv = T.nv, nb = T.nbody;
  load_rows(bk, f0.q, nq, io.qpos + b0 * nq, nq, nq, nS);
  load_rows(bk, f0.qd, nv, io.qvel + b0 * nv, nv, nv, nS);
  load_rows(bk, f0.arma, nv, io.armature + b0 * io.armature_bs, io.armature_bs, nv, nS);
  load_rows(bk, f0.mass, nb, io.mass + b0 * io.mass_bs, io.mass_bs, nb, nS);
  load_rows(bk, &f0.inertia[0][0], 3 * nb, io.inertia + b0 * io.inertia_bs, io.inertia_bs, 3 * nb, nS);
  load_rows(bk, f0.grav, 4, io.gravity + b0 * io.gravity_bs, io.gravity_bs, 3, nS);
}

// One scenario's geom and site frame poses into the staging regions.
template <class Team, class Tab>
RS_DEV void frames_team(const Team& tm, const Tab& T, const Fwd& s, const Frames& fr) {
  for (int g = tm.rank(); g < T.ngeom + T.nsite; g += tm.size()) {
    if (g < T.ngeom) {
      frame_pose(s, T.geom_bodyid[g], T.geom_pos[g], T.geom_quat[g], fr.gxpos[g], fr.gxmat[g]);
    } else {
      const int i = g - T.ngeom;
      frame_pose(s, T.site_bodyid[i], T.site_pos[i], T.site_quat[i], fr.sxpos[i], fr.sxmat[i]);
    }
  }
}

// The block's 13 output spans (scenarios b0 .. b0 + nS of B) from the
// regions of (f0, fr0), after a block sync.
template <class Blk, class Tab>
RS_DEV void k1_store(const Blk& bk, const Tab& T, const Fwd& f0, const Frames& fr0, size_t b0, int nS, size_t B,
                     float* out) {
  int n[RS_K1_NOUT];
  k1_sizes(T, n);
  const float* src[RS_K1_NOUT] = {&f0.xpos[0][0], &f0.xquat[0][0], &f0.xmat[0][0], &fr0.gxpos[0][0],
                                  &fr0.gxmat[0][0], &fr0.sxpos[0][0], &fr0.sxmat[0][0], &f0.sa[0][0],
                                  &f0.sl[0][0], f0.M, f0.bias, &f0.xipos[0][0], &f0.ximat[0][0]};
  for (int k = 0; k < RS_K1_NOUT; ++k) store_span(bk, out + k1_offset(n, k, B) + b0 * n[k], src[k], n[k] * nS);
}

// ---- K4's block ------------------------------------------------------------
//
// S scenarios, one thread each, in scenario-minor arrays of row stride P =
// S + 1 (row r, scenario s at r P + s): consecutive threads touch
// consecutive words, and a row's P words shift the banks by one, so the
// staging of the block's contiguous spans is conflict-free too.

// K4's shared memory for S scenarios, in words: the walk's rows of the
// model image, then qpos, the joint terms and the poses, each row-major
// over scenario-minor rows.
RS_HD int fk_block_words(const RsTables& T, int S) {
  Carver c{nullptr, 0};
  FwdTab F;
  carve_tab(T, c, F);
  return (F.walk_words + 3) / 4 * 4 + (S + 1) * (T.nq + 4 * T.njnt + 7 * T.nbody);
}

// Word e of a span of nS scenario-major rows of n words is (scenario e / n,
// row e % n) of a scenario-minor array `rows` (row stride P). The block's
// threads move a span four consecutive words a thread at a time (one
// 16-byte global access where aligned, four shared ones, all independent),
// each tracking its words' (s, r) without a division per word. TO_SPAN:
// rows -> span, else span -> rows.
template <bool TO_SPAN, class Blk>
RS_DEV void span_rows(const Blk& bk, const float* src, float* dst, int P, int n, int nS) {
  const int tid = bk.rank(), nt = bk.size(), total = n * nS, step = 4 * nt;
  const float* span = TO_SPAN ? dst : src;
  const bool vec = ((uintptr_t)span & 15) == 0;
  int s = 4 * tid / n, r = 4 * tid - s * n;
  const int ds = step / n, dr = step - ds * n;
  for (int e = 4 * tid; e < total; e += step) {
    int at[4];  // each word's place in rows
    for (int k = 0, ks = s, kr = r; k < 4; ++k) {
      at[k] = kr * P + ks;
      if (++kr == n) { kr = 0; ++ks; }
    }
    const bool whole = vec && e + 4 <= total;
    if (TO_SPAN) {
      float v[4];
      for (int k = 0; k < 4; ++k) v[k] = e + k < total ? src[at[k]] : 0.0f;
      if (whole) *reinterpret_cast<float4*>(dst + e) = float4{v[0], v[1], v[2], v[3]};
      else
        for (int k = 0; k < 4 && e + k < total; ++k) dst[e + k] = v[k];
    } else {
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (whole) {
        const float4 q = *reinterpret_cast<const float4*>(src + e);
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
      } else {
        for (int k = 0; k < 4 && e + k < total; ++k) v[k] = src[e + k];
      }
      for (int k = 0; k < 4 && e + k < total; ++k) dst[at[k]] = v[k];
    }
    s += ds;
    r += dr;
    if (r >= n) { r -= n; ++s; }
  }
}

// One K4 block over its S threads: scenarios b0 .. b0 + nS of qpos
// (B, nq) into xpos (B, nb, 3) and xquat (B, nb, 4), the walk's rows of
// the model image `tab` and the block's rows staged in sm
// (fk_block_words). `sync` is the block barrier.
template <class Blk>
RS_DEV void fk_block(const Blk& bk, const RsTables& T, const float* tab, float* sm, int S, size_t b0, int nS,
                     const float* qpos, float* xpos, float* xquat) {
  const int nq = T.nq, nb = T.nbody, P = S + 1;
  Carver ct{sm, 0};
  FwdTab F;
  carve_tab(T, ct, F);
  const int w = (F.walk_words + 3) / 4 * 4;
  float* qt = sm + w;
  float* jl = qt + nq * P;
  float* xp = jl + 4 * T.njnt * P;
  float* xq = xp + 3 * nb * P;
  const float* qs = qpos + b0 * nq;
  RS_STAMP(0);
  load_rows(bk, sm, w, tab, w, w, 1);
  span_rows<false>(bk, qs, qt, P, nq, nS);
  bk.sync();
  RS_STAMP(1);
  for (int s = bk.rank(); s < nS; s += bk.size()) {
    for (int j = 0; j < F.njnt; ++j) joint_terms(F, j, qt + s, P, jl + 4 * j * P + s, P);
    fk_walk<false>(F, qt + s, P, jl + s, P, xp + s, xq + s, P, nullptr, nullptr);
  }
  bk.sync();
  RS_STAMP(2);
  float* xps = xpos + b0 * 3 * nb;
  float* xqs = xquat + b0 * 4 * nb;
  span_rows<true>(bk, xp, xps, P, 3 * nb, nS);
  span_rows<true>(bk, xq, xqs, P, 4 * nb, nS);
  RS_STAMP(3);
}
