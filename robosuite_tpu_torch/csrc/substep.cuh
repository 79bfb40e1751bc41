// One whole physics substep of one scenario over its team (the fused
// substep, K3):
//   forward products (forward.cuh) -> the arm's torque law, OSC (osc.cuh)
//   or JOINT_POSITION (joint_pos.cuh), with its torque clip, and the
//   gripper ctrl -> smooth forces -> narrowphase + manifold cut
//   (narrowphase.cuh) -> contact rows with solref/solimp -> cone QP and
//   implicit-damping velocity solve (contact_solve.cuh) -> semi-implicit
//   qpos integration with free-joint quaternions [-> with AUX, the
//   post-step pose-only FK, site poses, body positions and per-pair
//   minimum distances (aux_tail)].
// Replaces robosuite_tpu/ops/pallas_substep.py _make_substep_kernel (OSC
// and JOINT_POSITION branches, with and without emit_aux); its plain
// versions are ops/substep.py substep_plain and substep_aux_plain. Only
// (qpos, qvel, goal, gains, grip, the runtime inertial leaves) come in and
// (qpos', qvel', f [, aux]) go out: everything between stays in the
// scenario's shared memory, carved by carve_substep from the model's own
// sizes.
#pragma once

#include "contact_solve.cuh"
#include "joint_pos.cuh"
#include "narrowphase.cuh"
#include "osc.cuh"

// One scenario's shared memory for the fused substep.
struct Sub {
  Fwd fw;
  Solve sv;
  Narrow nw;
  OscScratch* osc;
  float *ctrl, *tau, *qnew, *qvnew;
};

// The carve: the forward pass's arrays, the substep's small vectors, the
// pair frames and kept rows, the solver's vectors and factor, then one
// union U of regions that are live at different times: the CRBA/RNEA
// scratch (the forward pass), the OSC matrices (the torque law), the
// candidate depths (the narrowphase; again in the aux tail) and Y (the
// rows and the solve). -> the words a scenario takes, rounded to 4.
RS_HD int carve_substep(const RsTables& T, float* base, Sub& s) {
  const int nv = T.nv, K = T.nrows;
  Carver c{base, 0};
  carve_fwd(T, c, s.fw);
  s.ctrl = c.take(T.nu);
  s.tau = c.take(RS_MAXA);
  s.qnew = c.take(T.nq);
  s.qvnew = c.take(nv);
  s.nw.pf = take3<RS_PF>(c, T.npair);
  s.nw.row_cand = reinterpret_cast<int*>(c.take(K));
  s.nw.row_dist = c.take(K);
  carve_solve(nv, K, 0, c, s.sv);
  const int u0 = (c.w + 1) / 2 * 2;
  Carver cr{base, u0}, cy{base, u0}, cc{base, u0}, co{base, u0};
  carve_rnea(T, cr, s.fw);
  s.sv.Y = cy.take(y_words(nv, K, 0));
  s.nw.cd = cc.take(T.ncand);
  s.osc = reinterpret_cast<OscScratch*>(co.take(T.ctrl_type == RS_CTRL_OSC ? RS_OSC_WORDS : 0));
  int w = cr.w > cy.w ? cr.w : cy.w;
  w = w > cc.w ? w : cc.w;
  w = w > co.w ? w : co.w;
  return (w + 3) / 4 * 4;
}

// MuJoCo impedance d(x) of solimp = (d0, dmax, width, midpoint, power).
RS_DEV float impedance(const float* si, float x) {
  float xw = clampf(x / fmaxf(si[2], 1e-9f), 0.0f, 1.0f);
  float mid = si[3], pw = si[4];
  float a = 1.0f / powf(fmaxf(mid, 1e-9f), pw - 1.0f);
  float b = 1.0f / powf(fmaxf(1.0f - mid, 1e-9f), pw - 1.0f);
  float y = xw < mid ? a * powf(xw, pw) : 1.0f - b * powf(1.0f - xw, pw);
  return si[0] + y * (si[1] - si[0]);
}

// Contact rows (physics/contact.solver_inputs), one lane per row: the kept
// candidate's point and normal (computed again from its index), its
// contact frame, the Jacobian columns into the solver's Y buffer (Jf^T),
// aref, the regulariser base, mu and the active mask. Ends synchronised.
template <class Team>
RS_DEV void assemble_rows(const Team& tm, const RsTables& T, const Fwd& f, const Narrow& nw, const Solve& s) {
  const int K = T.nrows, nv = T.nv;
  for (int r = tm.rank(); r < K; r += tm.size()) {
    const int p = T.row_pair[r];
    const int b1 = T.pair_body1[p], b2 = T.pair_body2[p];
    float pos[3], nrm[3], n[3], ref[3], t1[3], t2[3], fr[9];
    candidate(T, nw.pf[p], p, nw.row_cand[r], pos, nrm);
    float nn = fmaxf(norm3(nrm), 1e-9f);
    for (int i = 0; i < 3; ++i) n[i] = nrm[i] / nn;
    bool use_ex = fabsf(n[0]) < 0.5f;
    ref[0] = use_ex ? 1.0f : 0.0f;
    ref[1] = use_ex ? 0.0f : 1.0f;
    ref[2] = 0.0f;
    v3_cross(n, ref, t1);
    float tn = fmaxf(norm3(t1), 1e-9f);
    for (int i = 0; i < 3; ++i) t1[i] /= tn;
    v3_cross(n, t1, t2);
    for (int i = 0; i < 3; ++i) {
      fr[i] = n[i];
      fr[3 + i] = t1[i];
      fr[6 + i] = t2[i];
    }
    float vel[3] = {0.0f, 0.0f, 0.0f};
    for (int d = 0; d < nv; ++d) {
      float sgn = T.anc[b2][d] - T.anc[b1][d];
      float c[3], jl[3];
      v3_cross(f.sa[d], pos, c);
      for (int i = 0; i < 3; ++i) jl[i] = f.sl[d][i] + c[i];
      for (int j = 0; j < 3; ++j) {
        float J = (fr[j * 3] * jl[0] + fr[j * 3 + 1] * jl[1] + fr[j * 3 + 2] * jl[2]) * sgn;
        s.Y[d * s.ldy + j * K + r] = J;
        vel[j] += J * f.qd[d];
      }
    }
    float pen = -(nw.row_dist[r] - T.pair_margin[p]);
    const float* si = T.pair_solimp[p];
    float di = clampf(impedance(si, pen), 1e-4f, 1.0f - 1e-4f);
    float tc = fmaxf(T.pair_solref[p][0], 2.0f * T.dt);
    float dr = fmaxf(T.pair_solref[p][1], 1e-3f);
    float dmax = clampf(si[1], 1e-4f, 1.0f - 1e-4f);
    float k = di / (dmax * dmax * tc * tc * dr * dr);
    float bb = 2.0f / (dmax * tc);
    float reg = (1.0f - di) / di;
    s.aref[r] = -bb * vel[0] + k * pen;
    s.aref[K + r] = -bb * vel[1];
    s.aref[2 * K + r] = -bb * vel[2];
    s.R[r] = reg;
    s.R[K + r] = reg / T.impratio;
    s.R[2 * K + r] = reg / T.impratio;
    s.mu[r] = T.pair_friction[p];
    s.act[r] = pen > 0.0f ? 1.0f : 0.0f;
  }
  tm.sync();
}

// Smooth forces and implicit damping (physics/engine._total_smooth_force)
// for the ctrl vector, one lane per dof (its actuators in order, its
// hinge or slide joint's spring and limit). Ends synchronised.
template <class Team>
RS_DEV void smooth_forces(const Team& tm, const RsTables& T, const Fwd& f, const float* ctrl, float* qfrc,
                          float* damp) {
  const int nv = T.nv;
  for (int d = tm.rank(); d < nv; d += tm.size()) {
    float act = 0.0f, spring = 0.0f, lim = 0.0f, extra = 0.0f;
    for (int a = 0; a < T.nu; ++a) {
      if (T.act_dofadr[a] != d) continue;
      float c = ctrl[a];
      if (T.act_ctrllimited[a] > 0.0f) c = clampf(c, T.act_ctrlrange[a][0], T.act_ctrlrange[a][1]);
      float gear = T.act_gear[a], force;
      if (T.act_kind[a] == RS_ACT_MOTOR) force = c;
      else if (T.act_kind[a] == RS_ACT_POSITION) force = T.act_gain[a] * (c - gear * f.q[T.act_qposadr[a]]);
      else force = T.act_gain[a] * (c - gear * f.qd[T.act_dofadr[a]]);
      if (T.act_forcelimited[a] > 0.0f) force = clampf(force, T.act_forcerange[a][0], T.act_forcerange[a][1]);
      act += gear * force;
    }
    for (int j = 0; j < T.njnt; ++j) {
      if ((T.jnt_type[j] != RS_HINGE && T.jnt_type[j] != RS_SLIDE) || T.jnt_dofadr[j] != d) continue;
      int qa = T.jnt_qposadr[j];
      spring = -T.jnt_stiffness[j] * (f.q[qa] - T.qpos_spring[qa]);
      // joint limits: mass-scaled spring-damper, d = 0.9, dmax = 0.95, solref (0.02, 1)
      float m_eff = f.M[d * nv + d];
      float kl = 0.9f / (0.95f * 0.95f * 0.02f * 0.02f * 1.0f * 1.0f) * m_eff;
      float bl = 2.0f / (0.95f * 0.02f) * m_eff;
      float d_lo = T.jnt_range[j][0] - f.q[qa], d_hi = f.q[qa] - T.jnt_range[j][1];
      float active = (d_lo > 0.0f || d_hi > 0.0f) ? 1.0f : 0.0f;
      lim = T.jnt_limited[j] * (kl * (fmaxf(d_lo, 0.0f) - fmaxf(d_hi, 0.0f)));
      extra = T.jnt_limited[j] * active * bl;
    }
    float fric = -T.dof_frictionloss[d] * tanhf(f.qd[d] / 0.005f);
    qfrc[d] = act + spring + lim + fric - f.bias[d];
    damp[d] = T.dof_damping[d] + extra;
  }
  tm.sync();
}

// Semi-implicit position update (physics/engine._integrate_qpos), one lane
// per joint. Ends synchronised.
template <class Team>
RS_DEV void integrate_qpos(const Team& tm, const RsTables& T, const float* q, const float* qv, float* out) {
  const float dt = T.dt;
  for (int i = tm.rank(); i < T.nq; i += tm.size()) out[i] = q[i];
  tm.sync();
  for (int j = tm.rank(); j < T.njnt; j += tm.size()) {
    int qa = T.jnt_qposadr[j], da = T.jnt_dofadr[j], jt = T.jnt_type[j];
    if (jt == RS_HINGE || jt == RS_SLIDE) {
      out[qa] += dt * qv[da];
      continue;
    }
    if (jt == RS_FREE) {
      for (int i = 0; i < 3; ++i) out[qa + i] += dt * qv[da + i];
      qa += 3;
      da += 3;
    }
    // q' = q * exp(0.5 w dt), w body-local; Taylor branch near 0; renormalise
    float v[3] = {qv[da] * dt, qv[da + 1] * dt, qv[da + 2] * dt};
    float sq = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
    bool small = sq < 1e-12f;
    float ang = sqrtf(small ? 1.0f : sq);
    float k = small ? 0.5f - sq / 48.0f : sinf(ang / 2.0f) / ang;
    float w = small ? 1.0f - sq / 8.0f : cosf(ang / 2.0f);
    float dq[4] = {w, v[0] * k, v[1] * k, v[2] * k}, o[4];
    quat_mul(out + qa, dq, o);
    float n = fmaxf(sqrtf(o[0] * o[0] + o[1] * o[1] + o[2] * o[2] + o[3] * o[3]), 1e-8f);
    for (int i = 0; i < 4; ++i) out[qa + i] = o[i] / n;
  }
  tm.sync();
}

// K3's aux tail (emit_aux): pose-only FK on the integrated qpos (the walk
// K1 and K4 run: joint terms over the lanes, the composition on one),
// written into the forward pass's pose arrays (free once the solve has
// run), then the post-step site poses, body positions and each pair's
// minimum candidate depth (narrowphase.cuh pair_min_team).
template <class Team>
RS_DEV void aux_tail(const Team& tm, const RsTables& T, const Sub& sh, size_t b, float* sxpos, float* sxmat,
                     float* bxpos, float* pdist) {
  const int tid = tm.rank(), nt = tm.size();
  const int nb = T.nbody, ns = T.nsite;
  const Fwd& fw = sh.fw;
  walk_team<false>(tm, T, sh.qnew, fw);
  for (int i = tid; i < nb; i += nt) {
    quat2mat(fw.xquat[i], fw.xmat[i]);
    for (int k = 0; k < 3; ++k) bxpos[(b * nb + i) * 3 + k] = fw.xpos[i][k];
  }
  tm.sync();
  for (int i = tid; i < ns; i += nt) {
    size_t o = b * ns + i;
    frame_pose(fw, T.site_bodyid[i], T.site_pos[i], T.site_quat[i], sxpos + o * 3, sxmat + o * 9);
  }
  candidates_team(tm, T, fw, sh.nw);
  pair_min_team(tm, T, sh.nw, pdist + b * T.npair);
}

// K3: one scenario's substep from global inputs to global outputs; with
// AUX, also the post-step aux outputs (aux_tail).
template <bool AUX, class Team>
RS_DEV void substep_body(const Team& tm, const RsTables& T, const Sub& sh, int b, const float* qpos,
                         const float* qvel, const float* mass, const float* inertia, const float* gravity,
                         const float* armature, const float* goal, const float* gains, const float* grip,
                         float* qpos_out, float* qvel_out, float* f_out, float* sxpos, float* sxmat, float* bxpos,
                         float* pdist) {
  const int tid = tm.rank(), nt = tm.size();
  const int nq = T.nq, nv = T.nv, nb = T.nbody, K = T.nrows, ntot = 3 * T.nrows;
  const Fwd& fw = sh.fw;
  const Solve& sv = sh.sv;
  RS_STAMP(0);
  for (int i = tid; i < nq; i += nt) fw.q[i] = qpos[(size_t)b * nq + i];
  for (int i = tid; i < nv; i += nt) {
    fw.qd[i] = sv.qvel[i] = qvel[(size_t)b * nv + i];
    fw.arma[i] = armature[(size_t)b * nv + i];
  }
  for (int i = tid; i < nb; i += nt) {
    fw.mass[i] = mass[(size_t)b * nb + i];
    for (int k = 0; k < 3; ++k) fw.inertia[i][k] = inertia[((size_t)b * nb + i) * 3 + k];
  }
  for (int i = tid; i < 3; i += nt) fw.grav[i] = gravity[(size_t)b * 3 + i];
  tm.sync();
  RS_STAMP(1);
  forward_team(tm, T, fw);
  const float* g = goal + (size_t)b * T.goal_stride;
  const float* k = gains + (size_t)b * T.gains_stride;
  if (T.ctrl_type == RS_CTRL_JOINT_POS) joint_pos_team(tm, T, fw, g, k, sh.tau);
  else osc_team(tm, T, fw, g, k, sh.tau, *sh.osc);
  RS_STAMP(6);
  for (int a = tid; a < T.nu; a += nt) {
    float c = 0.0f;
    for (int i = 0; i < T.na; ++i)
      if (T.arm_act[i] == a) c = sh.tau[i];
    for (int i = 0; i < T.ngrip; ++i)
      if (T.grip_act[i] == a) c = grip[(size_t)b * T.ngrip + i];
    sh.ctrl[a] = c;
  }
  tm.sync();
  smooth_forces(tm, T, fw, sh.ctrl, sv.qfrc, sv.damp);
  RS_STAMP(7);
  narrowphase_team(tm, T, fw, sh.nw);
  RS_STAMP(8);
  assemble_rows(tm, T, fw, sh.nw, sv);
  RS_STAMP(9);
  contact_solve_team(tm, sv, fw.M, nv, K, T.solver_iters, T.power_iters, T.dt, sh.qvnew);
  integrate_qpos(tm, T, fw.q, sh.qvnew, sh.qnew);
  for (int i = tid; i < nq; i += nt) qpos_out[(size_t)b * nq + i] = sh.qnew[i];
  for (int i = tid; i < nv; i += nt) qvel_out[(size_t)b * nv + i] = sh.qvnew[i];
  for (int c = tid; c < ntot; c += nt) f_out[(size_t)b * ntot + c] = sv.f[c];
  RS_STAMP(14);
  if constexpr (AUX) aux_tail(tm, T, sh, (size_t)b, sxpos, sxmat, bxpos, pdist);
  RS_STAMP(15);
}
