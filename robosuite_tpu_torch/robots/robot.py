"""Runtime robot: index resolution + the two-clock control flow (the JAX
package's robots/robot.py FixedBaseRobot; robosuite robots/robot.py,
fixed_base_robot.py:121-177).

Names resolve to indices once at construction; set_goals runs at policy
rate and run_controllers at substep rate, both pure functions of the
batched physics state and the explicit controller state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from robosuite_tpu_torch.controllers.base import ArmView
from robosuite_tpu_torch.controllers.factory import load_composite_controller_config
from robosuite_tpu_torch.controllers.parts import gripper as grip_mod
from robosuite_tpu_torch.controllers.parts import ik as ik_mod
from robosuite_tpu_torch.controllers.parts import joint_pos as jp_mod
from robosuite_tpu_torch.controllers.parts import joint_tor as jt_mod
from robosuite_tpu_torch.controllers.parts import joint_vel as jv_mod
from robosuite_tpu_torch.controllers.parts import osc as osc_mod
from robosuite_tpu_torch.physics import kinematics

# config class -> controller module (init_state / set_goal / run)
_CTRL_DISPATCH = {osc_mod.OSCConfig: osc_mod, jp_mod.JointPosConfig: jp_mod, ik_mod.IKConfig: ik_mod,
                  jv_mod.JointVelConfig: jv_mod, jt_mod.JointTorConfig: jt_mod}


def ctrl_module(cfg):
    """The part-controller module of an arm controller config."""
    for klass, mod in _CTRL_DISPATCH.items():
        if isinstance(cfg, klass):
            return mod
    raise TypeError(f"no controller module for config {type(cfg).__name__}")


@dataclasses.dataclass
class RobotCtrlState:
    """Per-robot controller state: arm goal states + gripper ramp."""

    arm: Dict[str, Any]  # arm -> the arm controller's state (OSCState, JointPosState, IKState, ...)
    gripper_action: Dict[str, torch.Tensor]  # arm -> (B, n_gripper_actuators) in [-1, 1]


class FixedBaseRobot:
    """Host-side handle of a fixed-base robot in a compiled model."""

    def __init__(self, model, robot_model, controller_config=None):
        self.model = model
        self.rm = robot_model
        self.arms = list(robot_model.arms)
        self.arm_qpos_idx, self.arm_qvel_idx, self.arm_actuator_ids = {}, {}, {}
        self.gripper_joint_qpos_idx, self.gripper_joint_qvel_idx, self.gripper_actuator_ids = {}, {}, {}
        self.eef_site_id, self.center_site_id = {}, {}
        for arm in self.arms:
            jids = [model.jnt_name2id(n) for n in robot_model.arm_joint_names[arm]]
            self.arm_qpos_idx[arm] = np.array([model.jnt_qposadr[j] for j in jids])
            self.arm_qvel_idx[arm] = np.array([model.jnt_dofadr[j] for j in jids])
            self.arm_actuator_ids[arm] = np.array(
                [model.actuator_name2id(n) for n in robot_model.arm_actuator_names[arm]])
            grip = robot_model.grippers[arm]  # a gripper with no joints and actuators (NullGripper) gives empty ones
            gj = [model.jnt_name2id(n) for n in grip.joint_names]
            self.gripper_joint_qpos_idx[arm] = np.array([model.jnt_qposadr[j] for j in gj], dtype=int)
            self.gripper_joint_qvel_idx[arm] = np.array([model.jnt_dofadr[j] for j in gj], dtype=int)
            self.gripper_actuator_ids[arm] = np.array([model.actuator_name2id(n) for n in grip.actuator_names],
                                                      dtype=int)
            self.eef_site_id[arm] = model.site_name2id(grip.important_sites["grip_site"])
            self.center_site_id[arm] = model.site_name2id(robot_model.center_site_name(arm))

        # torque limits from the actuator ctrlrange (robosuite robot.py:562-575)
        rng = model.actuator_ctrlrange.cpu().numpy()
        self.torque_limits = {
            arm: (rng[self.arm_actuator_ids[arm], 0], rng[self.arm_actuator_ids[arm], 1]) for arm in self.arms
        }
        self.arm_cfg = load_composite_controller_config(
            controller_config, robot=type(robot_model).__name__, arms=self.arms)
        # nullspace target: the robot's init qpos (card order)
        iq = np.asarray(robot_model.init_qpos, dtype=np.float32)
        card = robot_model.card_joint_names
        self.initial_joint = {
            arm: torch.as_tensor(iq[[card.index(n) for n in robot_model.arm_joint_names[arm]]], device=model.device)
            for arm in self.arms
        }
        self.init_qpos_idx = np.array([model.jnt_qposadr[model.jnt_name2id(n)] for n in card], dtype=int)
        # the per-substep indices and constants on the model's device (an
        # index from the host is a copy, and a copy waits for the device)
        dev = model.device
        idx = lambda a: None if a is None else torch.as_tensor(a, dtype=torch.long, device=dev)  # noqa: E731
        self._dev = {arm: dict(
            qp=idx(self.arm_qpos_idx[arm]), qv=idx(self.arm_qvel_idx[arm]), act=idx(self.arm_actuator_ids[arm]),
            grip_act=idx(self.gripper_actuator_ids[arm]),
            lo=torch.as_tensor(self.torque_limits[arm][0], device=dev),
            hi=torch.as_tensor(self.torque_limits[arm][1], device=dev),
            grip_range=model.actuator_ctrlrange[idx(self.gripper_actuator_ids[arm])],
            grip_dir=torch.as_tensor(robot_model.grippers[arm].format_action_direction(), dtype=torch.float32,
                                     device=dev),
            grip_idx=idx(robot_model.grippers[arm].format_action_indices()),
            grip_fixed=self._pinned(robot_model.grippers[arm].format_action_fixed(), dev)) for arm in self.arms}
        # check_q_limits: every arm's joint positions and ranges, the limited ones
        jr = model.jnt_range.cpu().numpy()
        jids = np.concatenate([[int(model.dof_jntid[d]) for d in self.arm_qvel_idx[arm]] for arm in self.arms])
        lim = jr[jids]
        self._q_limits = dict(qp=idx(np.concatenate([self.arm_qpos_idx[arm] for arm in self.arms])),
                              lo=torch.as_tensor(lim[:, 0], device=dev), hi=torch.as_tensor(lim[:, 1], device=dev),
                              limited=torch.as_tensor(lim[:, 0] != lim[:, 1], device=dev))

    @staticmethod
    def _pinned(fixed, dev):
        """(mask, values) of a gripper's pinned actuator commands
        (format_action_fixed), or None."""
        if fixed is None:
            return None
        fixed = np.asarray(fixed, dtype=np.float32)
        return (torch.as_tensor(~np.isnan(fixed), device=dev),
                torch.as_tensor(np.nan_to_num(fixed), dtype=torch.float32, device=dev))

    # -- action vector layout (robosuite composite_controller.py:86-95) ------
    @property
    def action_dim(self) -> int:
        return sum(self.arm_cfg[a].control_dim + self.rm.grippers[a].dof for a in self.arms)

    @property
    def action_limits(self):
        """(low, high) of each action dim (robosuite controller control_limits,
        osc.py:190-211): [-1, 1], but a variable-impedance arm's damping
        ratios and gains carry their limits."""
        low, high = -np.ones(self.action_dim, dtype=np.float32), np.ones(self.action_dim, dtype=np.float32)
        idx = self.action_split_indexes()
        for arm in self.arms:
            cfg, (s, _) = self.arm_cfg[arm], idx[arm]
            mode = cfg.impedance_mode if isinstance(cfg, osc_mod.OSCConfig) else "fixed"
            if mode == "variable":
                low[s:s + 6], high[s:s + 6] = cfg.damping_ratio_limits
                low[s + 6:s + 12], high[s + 6:s + 12] = cfg.kp_limits
            elif mode == "variable_kp":
                low[s:s + 6], high[s:s + 6] = cfg.kp_limits
        return low, high

    def check_q_limits(self, qpos, tolerance=0.1):
        """(B,) True where any limited arm joint is within `tolerance` of an
        end of its range (robosuite robots/robot.py:509-523)."""
        d = self._q_limits
        q = qpos[:, d["qp"]]
        near = (q <= d["lo"] + tolerance) | (q >= d["hi"] - tolerance)
        return (near & d["limited"]).any(dim=-1)

    def action_split_indexes(self):
        """arm parts first, grippers last."""
        out, i = {}, 0
        for arm in self.arms:
            out[arm] = (i, i + self.arm_cfg[arm].control_dim)
            i += self.arm_cfg[arm].control_dim
        for arm in self.arms:
            out[f"{arm}_gripper"] = (i, i + self.rm.grippers[arm].dof)
            i += self.rm.grippers[arm].dof
        return out

    # -- views ---------------------------------------------------------------
    def arm_view(self, kin, M, bias, qpos, qvel, arm: str) -> ArmView:
        """The per-substep controller view (robosuite controller.py:199-232)."""
        qp_i, qv_i = self._dev[arm]["qp"], self._dev[arm]["qv"]
        eef, cen = self.eef_site_id[arm], self.center_site_id[arm]
        jacp, jacr = kinematics.site_jacobian(self.model, kin, eef)
        lin, ang = kinematics.site_velocity(self.model, kin, qvel, eef)
        olin, oang = kinematics.site_velocity(self.model, kin, qvel, cen)
        return ArmView(
            joint_pos=qpos[:, qp_i], joint_vel=qvel[:, qv_i],
            ref_pos=kin.site_xpos[:, eef], ref_ori_mat=kin.site_xmat[:, eef],
            ref_pos_vel=lin, ref_ori_vel=ang,
            J_pos=jacp[:, :, qv_i], J_ori=jacr[:, :, qv_i],
            mass_matrix=M[:, qv_i][:, :, qv_i], torque_compensation=bias[:, qv_i],
            initial_joint=self.initial_joint[arm],
            origin_pos=kin.site_xpos[:, cen], origin_ori=kin.site_xmat[:, cen],
            origin_pos_vel=olin, origin_ori_vel=oang,
        )

    # -- two-clock control -----------------------------------------------------
    def init_ctrl_state(self, kin, M, bias, qpos, qvel) -> RobotCtrlState:
        B = qpos.shape[0]
        arm_states, grip_actions = {}, {}
        for arm in self.arms:
            cfg = self.arm_cfg[arm]
            arm_states[arm] = ctrl_module(cfg).init_state(cfg, self.arm_view(kin, M, bias, qpos, qvel, arm))
            # one ramp entry per gripper actuator, and one for a gripper with
            # none (NullGripper), never moved and never fed to an actuator
            # (the JAX robot.py pads to max(n_act, 1), so the MPC state x
            # has the same width in both packages)
            grip_actions[arm] = torch.zeros(B, max(len(self.gripper_actuator_ids[arm]), 1), dtype=qpos.dtype,
                                            device=qpos.device)
        return RobotCtrlState(arm=arm_states, gripper_action=grip_actions)

    def set_goals(self, kin, M, bias, qpos, qvel, ctrl_state: RobotCtrlState, action) -> RobotCtrlState:
        """Policy-rate goal update (robosuite composite set_goal)."""
        idx = self.action_split_indexes()
        new_arm, new_grip = {}, {}
        for arm in self.arms:
            s, e = idx[arm]
            cfg = self.arm_cfg[arm]
            if isinstance(cfg, jt_mod.JointTorConfig):  # the goal torques clip to the arm's limits
                d = self._dev[arm]
                new_arm[arm] = jt_mod.set_goal(cfg, ctrl_state.arm[arm], action[:, s:e], d["lo"], d["hi"])
            else:
                view = self.arm_view(kin, M, bias, qpos, qvel, arm)
                new_arm[arm] = ctrl_module(cfg).set_goal(cfg, ctrl_state.arm[arm], view, action[:, s:e])
            gs, ge = idx[f"{arm}_gripper"]
            cur = ctrl_state.gripper_action[arm]
            new_grip[arm] = self._gripper_goal(arm, cur, action[:, gs:ge]) if self.rm.grippers[arm].dof else cur
        return RobotCtrlState(arm=new_arm, gripper_action=new_grip)

    def _gripper_goal(self, arm, cur, grip_a):
        """Per-actuator gripper command in [-1, 1] (the JAX robot.py
        _gripper_goal). A binary gripper ramps (robosuite
        panda_gripper.py:42-55): each policy step moves the per-actuator
        command by speed * sign(action). A dexterous hand maps its dof-wide
        action straight onto its actuators (inspire_hands.py:22-28); a
        dexterous ramped gripper ramps each actuator from its own action
        element (jaco_three_finger_gripper.py:82-108); pinned actuators
        keep their command (robotiq_three_finger_gripper.py:78)."""
        d = self._dev[arm]
        if d["grip_idx"] is not None:
            return torch.clamp(grip_a[:, d["grip_idx"]].to(cur.dtype), -1.0, 1.0)
        grip = self.rm.grippers[arm]
        sign = torch.sign(grip_a if grip.ramp_elementwise else grip_a[:, 0:1])
        new = torch.clamp(cur + d["grip_dir"].to(cur.dtype) * grip.speed * sign, -1.0, 1.0)
        if d["grip_fixed"] is not None:
            mask, value = d["grip_fixed"]
            new = torch.where(mask, value.to(new.dtype), new)
        return new

    def gripper_ctrl(self, arm, ctrl_state: RobotCtrlState):
        """Actuator-space gripper ctrl (B, n) for the tick's gripper state
        ((B, 0) for a gripper with no actuators: its pad entry feeds none)."""
        rng = self._dev[arm]["grip_range"]
        return grip_mod.run(ctrl_state.gripper_action[arm][:, :rng.shape[0]], rng[:, 0], rng[:, 1])

    def run_controllers(self, kin, M, bias, qpos, qvel, ctrl_state: RobotCtrlState, ctrl, substep=None):
        """Substep-rate torques written into the full (B, nu) ctrl
        (robosuite fixed_base_robot.py:149-153); `substep`, the index within
        the policy step, drives OSC's goal interpolation. JOINT_VELOCITY
        clips to the actuator limits, and its new PID state is dropped, as
        the JAX package drops it (robot.py:555): the error history stays at
        init_state's zeros."""
        ctrl = ctrl.clone()
        for arm in self.arms:
            view = self.arm_view(kin, M, bias, qpos, qvel, arm)
            cfg = self.arm_cfg[arm]
            d = self._dev[arm]
            if isinstance(cfg, jv_mod.JointVelConfig):
                tau, _ = jv_mod.run(cfg, ctrl_state.arm[arm], view, d["lo"], d["hi"])
            elif isinstance(cfg, osc_mod.OSCConfig):
                tau = osc_mod.run(cfg, ctrl_state.arm[arm], view, substep=substep)
            else:
                tau = ctrl_module(cfg).run(cfg, ctrl_state.arm[arm], view)
            ctrl[:, d["act"]] = torch.clamp(tau, d["lo"], d["hi"])
            ctrl[:, d["grip_act"]] = self.gripper_ctrl(arm, ctrl_state)
        return ctrl
