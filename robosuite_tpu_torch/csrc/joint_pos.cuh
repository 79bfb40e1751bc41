// JOINT_POSITION torque law for one scenario (one lane per arm joint,
// float32 as the plain version): controllers/parts/joint_pos.py run (robosuite
// joint_pos.py:233-272), then the torque clip.
//   goal  = goal_qpos (na)
//   gains = [kp (na), kd (na)]
//   tau = M_arm (kp (goal - q) - kd qdot) + bias   (torque compensation)
//   tau = kp (goal - q) - kd qdot [+ bias]         (raw_pd, or no compensation)
// Replaces the JOINT_POSITION section of robosuite_tpu/ops/pallas_substep.py
// _make_substep_kernel (:895-913), which always shapes by M_arm; this
// follows the plain version, which shapes only with torque compensation
// (the two agree for the default config, use_torque_compensation=True).
#pragma once

#include "forward.cuh"

template <class Team>
RS_DEV void joint_pos_team(const Team& tm, const RsTables& T, const Fwd& s, const float* goal, const float* gains,
                           float* tau) {
  const int na = T.na, nv = T.nv;
  const bool shaped = T.torque_comp && !T.raw_pd;
  for (int i = tm.rank(); i < na; i += tm.size()) {
    float v;
    if (shaped) {
      v = 0.0f;
      for (int j = 0; j < na; ++j) {
        float des = (goal[j] - s.q[T.arm_qp[j]]) * gains[j] - s.qd[T.arm_qv[j]] * gains[na + j];
        v += s.M[T.arm_qv[i] * nv + T.arm_qv[j]] * des;
      }
    } else {
      v = (goal[i] - s.q[T.arm_qp[i]]) * gains[i] - s.qd[T.arm_qv[i]] * gains[na + i];
    }
    if (T.torque_comp) v += s.bias[T.arm_qv[i]];
    tau[i] = clampf(v, T.torque_lo[i], T.torque_hi[i]);
  }
  tm.sync();
}
