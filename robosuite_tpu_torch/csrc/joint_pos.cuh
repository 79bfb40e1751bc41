// JOINT_POSITION torque law for one scenario (one thread, float32 as the
// plain version): controllers/parts/joint_pos.py run (robosuite
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

RS_DEV void joint_pos_torques(const RsTables& T, const FwdShared& s, const float* goal, const float* gains,
                              float* tau) {
  const int na = T.na;
  const bool shaped = T.torque_comp && !T.raw_pd;
  float des[RS_MAXA];
  for (int i = 0; i < na; ++i)
    des[i] = (goal[i] - s.q[T.arm_qp[i]]) * gains[i] - s.qd[T.arm_qv[i]] * gains[na + i];
  for (int i = 0; i < na; ++i) {
    float v = des[i];
    if (shaped) {
      v = 0.0f;
      for (int j = 0; j < na; ++j) v += s.M[T.arm_qv[i]][T.arm_qv[j]] * des[j];
    }
    if (T.torque_comp) v += s.bias[T.arm_qv[i]];
    tau[i] = clampf(v, T.torque_lo[i], T.torque_hi[i]);
  }
}
