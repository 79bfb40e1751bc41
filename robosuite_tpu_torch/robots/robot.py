"""Runtime robots: index resolution + the two-clock control flow (the JAX
package's robots/robot.py; robosuite robots/robot.py,
fixed_base_robot.py:121-177, mobile_robot.py, wheeled_robot.py,
legged_robot.py).

Names resolve to indices once at construction; set_goals runs at policy
rate and run_controllers at substep rate, both pure functions of the
batched physics state and the explicit controller state. FixedBaseRobot
runs the arms and grippers under BASIC, WHOLE_BODY_IK (one joint solve
over the torso and arms, composite/wbik.py) or a registered third-party
composite; MobileRobot adds the torso, head and base parts (and
HYBRID_MOBILE_BASE's base-mode flag); LeggedRobot adds the legs' servo.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from robosuite_tpu_torch.controllers import control_utils as CU
from robosuite_tpu_torch.controllers.base import ArmView, nums2array
from robosuite_tpu_torch.controllers.composite import wbik as wbik_mod
from robosuite_tpu_torch.controllers.composite.composite_controller import CompositeControllerSpec
from robosuite_tpu_torch.controllers.factory import body_part_config, resolve_composite
from robosuite_tpu_torch.controllers.parts import gripper as grip_mod
from robosuite_tpu_torch.controllers.parts import ik as ik_mod
from robosuite_tpu_torch.controllers.parts import joint_pos as jp_mod
from robosuite_tpu_torch.controllers.parts import joint_tor as jt_mod
from robosuite_tpu_torch.controllers.parts import joint_vel as jv_mod
from robosuite_tpu_torch.controllers.parts import mobile_base as mb_mod
from robosuite_tpu_torch.controllers.parts import osc as osc_mod
from robosuite_tpu_torch.physics import kinematics
from robosuite_tpu_torch.utils import transforms as T

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

    # arm -> the arm controller's state (OSCState, JointPosState, IKState,
    # ...), and a mobile robot's parts: torso / head / legs -> JointPosState,
    # base -> MobileBaseState
    arm: Dict[str, Any]
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
        # the composite (robosuite composite_controller_factory.py): BASIC's
        # arm configs, WHOLE_BODY_IK's specific configs (wbik_spec) or a
        # registered third-party composite (custom); the resolved JSON's
        # body_parts hold a mobile robot's part gains
        comp = resolve_composite(controller_config, type(robot_model).__name__,
                                 {arm: len(self.arm_qpos_idx[arm]) for arm in self.arms})
        self.composite_type, self._composite_json = comp.type, comp.json
        self.arm_cfg, self.wbik_spec, self.custom_composite = comp.arm_cfg, comp.wbik, comp.custom
        self.hybrid = False  # HYBRID_MOBILE_BASE's trailing base-mode flag (MobileRobot)
        self._wbik = None
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
    def _part_dims(self) -> Dict[str, int]:
        """The mobile parts' action widths: none on a fixed base."""
        return {}

    @property
    def composite_spec(self) -> CompositeControllerSpec:
        """The composite this robot runs, as data; its split is the action
        layout. A whole-body composite's arm takes a task-space target
        (WHOLE_BODY_IK: 6, a third-party one: its arm_action_dim), and
        under WHOLE_BODY_IK no mobile part takes an action."""
        wide = None
        if self.custom_composite is not None:
            ctype, wide = self.custom_composite[0].name, self.custom_composite[0].arm_action_dim
        elif self.wbik_spec is not None:
            ctype, wide = "WHOLE_BODY_IK", 6
        else:
            ctype = "HYBRID_MOBILE_BASE" if self.hybrid else "BASIC"
        return CompositeControllerSpec(
            type=ctype, arm_configs={arm: self.arm_cfg[arm] for arm in self.arms},
            gripper_dims={arm: self.rm.grippers[arm].dof for arm in self.arms},
            part_dims={} if ctype == "WHOLE_BODY_IK" else self._part_dims(),
            arm_action_dims={arm: wide for arm in self.arms} if wide else {})

    @property
    def action_dim(self) -> int:
        return self.composite_spec.action_dim

    @property
    def action_limits(self):
        """(low, high) of each action dim (robosuite controller control_limits,
        osc.py:190-211): [-1, 1], but a variable-impedance arm's damping
        ratios and gains carry their limits."""
        low, high = -np.ones(self.action_dim, dtype=np.float32), np.ones(self.action_dim, dtype=np.float32)
        idx = self.action_split_indexes()
        if self.wbik_spec is not None:
            # task-space pose targets (robosuite's IK control limits are
            # unbounded, ik_utils.py:77): the reach and a full axis-angle
            for arm in self.arms:
                low[slice(*idx[arm])], high[slice(*idx[arm])] = -3.2, 3.2
            return low, high
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
        """part -> (start, end): the arms, the mobile parts, the grippers,
        HYBRID_MOBILE_BASE's base_mode (composite_spec)."""
        return self.composite_spec.split_indexes()

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

    # -- WHOLE_BODY_IK (robosuite composite_controller.py:514-589) -------------
    def _wbik_build(self):
        """The whole-body IK problem, resolved once: the selected dofs (a
        mobile robot's torso, then every arm), the nullspace weights by
        joint name (suffix matched, default 1), the torso mask."""
        if self._wbik is not None:
            return self._wbik
        spec, model = self.wbik_spec, self.model
        parts = self._wbik_parts()
        slices, n = {}, 0
        for name, qp, _, _ in parts:
            slices[name] = slice(n, n + len(qp))
            n += len(qp)
        qpos_idx = np.concatenate([p[1] for p in parts]).astype(int)
        qvel_idx = np.concatenate([p[2] for p in parts]).astype(int)
        weights = spec.get("nullspace_joint_weights", {})
        gains = []
        for dof in qvel_idx:
            jname = model.jnt_names[model.dof_jntid[dof]]
            w = weights.get(jname)
            if w is None:
                w = next((v for k, v in weights.items() if jname.endswith(k) or k.endswith(jname)), 1.0)
            gains.append(float(w))
        cfg = wbik_mod.WBIKConfig(
            damping=float(spec.get("ik_pseudo_inverse_damping", 5e-2)),
            integration_dt=float(spec.get("ik_integration_dt", 0.1)),
            max_dq=float(spec.get("ik_max_dq", spec.get("max_dq", 4.0))),
            max_dq_torso=float(spec.get("ik_max_dq_torso", 0.2)), nullspace_gains=tuple(gains),
            torso_mask=tuple(t for _, qp, _, t in parts for _ in qp),
            **({"input_type": spec["ik_input_type"]} if "ik_input_type" in spec else {}))
        dev = model.device
        qp = torch.as_tensor(qpos_idx, dtype=torch.long, device=dev)
        self._wbik = dict(cfg=cfg, qp=qp, qv=torch.as_tensor(qvel_idx, dtype=torch.long, device=dev), slices=slices,
                          q0=model.qpos0[qp])
        return self._wbik

    def _wbik_parts(self):
        """[(part, qpos indices, qvel indices, 1.0 for a torso)] the
        whole-body solve runs over: every arm (MobileRobot puts its torso
        first)."""
        return [(arm, self.arm_qpos_idx[arm], self.arm_qvel_idx[arm], 0.0) for arm in self.arms]

    def _joint_goals(self, ctrl_state, goals, action):
        """The new state from joint-position goals {part: (B, n)} (each
        part's gains kept) and the grippers' slices of the action."""
        idx = self.action_split_indexes()
        new, new_grip = dict(ctrl_state.arm), dict(ctrl_state.gripper_action)
        for name, q_des in goals.items():
            prev = ctrl_state.arm[name]
            new[name] = jp_mod.JointPosState(goal_qpos=q_des, kp=prev.kp, kd=prev.kd)
        for arm in self.arms:
            if self.rm.grippers[arm].dof:
                new_grip[arm] = self._gripper_goal(arm, ctrl_state.gripper_action[arm],
                                                   action[:, slice(*idx[f"{arm}_gripper"])])
        return RobotCtrlState(arm=new, gripper_action=new_grip)

    def _set_goals_wbik(self, kin, M, bias, qpos, qvel, ctrl_state, action):
        """WHOLE_BODY_IK's policy-rate update: each arm's 6-wide target (its
        position and axis-angle in the arm's base frame, or a delta about
        the eef pose) -> one solve over the torso and arms -> the parts'
        JOINT_POSITION goals."""
        w = self._wbik_build()
        idx = self.action_split_indexes()
        tpos, tmat, spos, smat, Js = [], [], [], [], []
        for arm in self.arms:
            a = action[:, slice(*idx[arm])]
            view = self.arm_view(kin, M, bias, qpos, qvel, arm)
            R_a = T.quat2mat(T.axisangle2quat(a[:, 3:6]))
            if w["cfg"].input_type == "absolute":
                tpos.append(view.origin_pos + (view.origin_ori @ a[:, :3, None])[..., 0])
                tmat.append(view.origin_ori @ R_a)
            else:
                tpos.append(view.ref_pos + a[:, :3])
                tmat.append(R_a @ view.ref_ori_mat)
            spos.append(view.ref_pos)
            smat.append(view.ref_ori_mat)
            jacp, jacr = kinematics.site_jacobian(self.model, kin, self.eef_site_id[arm])
            Js.append(torch.cat([jacp[:, :, w["qv"]], jacr[:, :, w["qv"]]], dim=1))
        q_des = wbik_mod.wbik_solve(w["cfg"], torch.cat(Js, dim=1), qpos[:, w["qp"]], w["q0"],
                                    torch.stack(spos, 1), torch.stack(smat, 1), torch.stack(tpos, 1),
                                    torch.stack(tmat, 1))
        return self._joint_goals(ctrl_state, {name: q_des[:, sl] for name, sl in w["slices"].items()}, action)

    def _set_goals_custom(self, kin, M, bias, qpos, qvel, ctrl_state, action):
        """A third-party composite's policy-rate update: its goal transform
        maps the arms' targets to joint-position goals, tracked by the
        JOINT_POSITION part controllers (robosuite composite_controller.py:
        15-27)."""
        entry, cfg = self.custom_composite
        idx = self.action_split_indexes()
        targets = {arm: action[:, slice(*idx[arm])] for arm in self.arms}
        return self._joint_goals(ctrl_state, entry.goal_fn(self, kin, qpos, qvel, targets, cfg), action)

    def set_goals(self, kin, M, bias, qpos, qvel, ctrl_state: RobotCtrlState, action,
                  wrt_origin=None) -> RobotCtrlState:
        """Policy-rate goal update (robosuite composite set_goal); wrt_origin,
        (B,) bool or None, goes to the OSC arms (HYBRID_MOBILE_BASE's base
        moving: MobileRobot.set_goals)."""
        if self.custom_composite is not None:
            return self._set_goals_custom(kin, M, bias, qpos, qvel, ctrl_state, action)
        if self.wbik_spec is not None:
            return self._set_goals_wbik(kin, M, bias, qpos, qvel, ctrl_state, action)
        idx = self.action_split_indexes()
        new_arm, new_grip = {}, {}
        for arm in self.arms:
            s, e = idx[arm]
            cfg = self.arm_cfg[arm]
            if isinstance(cfg, jt_mod.JointTorConfig):  # the goal torques clip to the arm's limits
                d = self._dev[arm]
                new_arm[arm] = jt_mod.set_goal(cfg, ctrl_state.arm[arm], action[:, s:e], d["lo"], d["hi"])
            elif isinstance(cfg, osc_mod.OSCConfig):
                view = self.arm_view(kin, M, bias, qpos, qvel, arm)
                new_arm[arm] = osc_mod.set_goal(cfg, ctrl_state.arm[arm], view, action[:, s:e], wrt_origin=wrt_origin)
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


_PARTS = ("torso", "head", "base", "legs")


class MobileRobot(FixedBaseRobot):
    """A wheeled (or, through LeggedRobot, legged) robot (the JAX
    robots/robot.py:601-793; robosuite robots/mobile_robot.py,
    wheeled_robot.py): the arm and gripper stack plus the torso and head
    (JOINT_POSITION) and the base (mobile_base's joint velocities) parts.
    The action: arms, torso, head, base, legs, grippers, and under
    HYBRID_MOBILE_BASE a trailing base-mode flag (composite_controller.py:
    86-95, 234-291); under WHOLE_BODY_IK the arms' targets and the grippers
    only, the parts holding their goals."""

    def __init__(self, model, robot_model, controller_config=None):
        super().__init__(model, robot_model, controller_config)
        rm = robot_model
        joints = dict(torso=rm.torso_joints, head=rm.head_joints, base=rm.base_joints, legs=rm.legs_joints)
        act_by_jnt = {int(j): i for i, j in enumerate(model.actuator_jntid)}
        self.part_qpos_idx, self.part_qvel_idx, self.part_actuator_ids = {}, {}, {}
        for part in _PARTS:
            jids = [model.jnt_name2id(n) for n in joints[part]]
            self.part_qpos_idx[part] = np.array([model.jnt_qposadr[j] for j in jids], dtype=int)
            self.part_qvel_idx[part] = np.array([model.jnt_dofadr[j] for j in jids], dtype=int)
            self.part_actuator_ids[part] = np.array([act_by_jnt[j] for j in jids if j in act_by_jnt], dtype=int)
        self.base_center_site = model.site_name2id(rm.base.center_site)
        kp = getattr(rm, "part_controller_kp", {})
        self.part_cfg = {part: body_part_config(self._composite_json, part, len(self.part_qpos_idx[part]),
                                                kp.get(part, 1000.0))
                         for part in ("torso", "head", "legs") if len(self.part_qpos_idx[part])}
        if len(self.part_qpos_idx["base"]):
            self.part_cfg["base"] = mb_mod.MobileBaseJointVelConfig(dim=len(self.part_qpos_idx["base"]))
        self.hybrid = (self.composite_type or getattr(rm, "composite_type", "BASIC")) == "HYBRID_MOBILE_BASE"
        dev, rng = model.device, model.actuator_ctrlrange
        self._part_dev = {}
        for part in _PARTS:
            aid = torch.as_tensor(self.part_actuator_ids[part], dtype=torch.long, device=dev)
            self._part_dev[part] = dict(
                qp=torch.as_tensor(self.part_qpos_idx[part], dtype=torch.long, device=dev),
                qv=torch.as_tensor(self.part_qvel_idx[part], dtype=torch.long, device=dev),
                act=aid, lo=rng[aid, 0], hi=rng[aid, 1])

    # -- views ------------------------------------------------------------------
    def _part_view(self, kin, M, bias, qpos, qvel, part: str) -> ArmView:
        """A joint-space part's view: its joints, mass matrix block and bias
        (the task-space fields, which JOINT_POSITION does not read, zero)."""
        d = self._part_dev[part]
        qv = d["qv"]
        B, n = qpos.shape[0], qv.shape[0]
        z3 = qpos.new_zeros(B, 3)
        e3 = torch.eye(3, dtype=qpos.dtype, device=qpos.device).expand(B, 3, 3)
        return ArmView(joint_pos=qpos[:, d["qp"]], joint_vel=qvel[:, qv], ref_pos=z3, ref_ori_mat=e3,
                       ref_pos_vel=z3, ref_ori_vel=z3, J_pos=qpos.new_zeros(B, 3, n), J_ori=qpos.new_zeros(B, 3, n),
                       mass_matrix=M[:, qv][:, :, qv], torque_compensation=bias[:, qv],
                       initial_joint=qpos.new_zeros(n), origin_pos=z3, origin_ori=e3, origin_pos_vel=z3,
                       origin_ori_vel=z3)

    def _base_yaw(self, kin):
        """(B,) the base's yaw, from its centre site."""
        R = kin.site_xmat[:, self.base_center_site]
        return torch.atan2(R[:, 1, 0], R[:, 0, 0])

    # -- action layout ------------------------------------------------------------
    def _part_dims(self) -> Dict[str, int]:
        return {p: self.part_cfg[p].control_dim for p in _PARTS if p in self.part_cfg}

    def _wbik_parts(self):
        torso = ([("torso", self.part_qpos_idx["torso"], self.part_qvel_idx["torso"], 1.0)]
                 if "torso" in self.part_cfg else [])
        return torso + super()._wbik_parts()

    # -- two-clock control ---------------------------------------------------------
    def init_ctrl_state(self, kin, M, bias, qpos, qvel) -> RobotCtrlState:
        st = super().init_ctrl_state(kin, M, bias, qpos, qvel)
        parts = dict(st.arm)
        for part in ("torso", "head", "legs"):
            if part in self.part_cfg:
                parts[part] = jp_mod.init_state(self.part_cfg[part], self._part_view(kin, M, bias, qpos, qvel, part))
        if "base" in self.part_cfg:
            parts["base"] = mb_mod.init_state(self.part_cfg["base"], self._base_yaw(kin))
        return RobotCtrlState(arm=parts, gripper_action=st.gripper_action)

    def set_goals(self, kin, M, bias, qpos, qvel, ctrl_state: RobotCtrlState, action) -> RobotCtrlState:
        # the base moving (mode > 0): an OSC arm's delta moves the previous
        # goal, else the achieved pose (composite_controller.py:255-266)
        st = super().set_goals(kin, M, bias, qpos, qvel, ctrl_state, action,
                               wrt_origin=action[:, -1] > 0 if self.hybrid else None)
        if self.custom_composite is not None or self.wbik_spec is not None:
            return st  # the parts hold their goals
        idx = self.action_split_indexes()
        new = dict(st.arm)
        for part in ("torso", "head", "legs"):
            if part in self.part_cfg:
                view = self._part_view(kin, M, bias, qpos, qvel, part)
                new[part] = jp_mod.set_goal(self.part_cfg[part], ctrl_state.arm[part], view,
                                            action[:, slice(*idx[part])])
        if "base" in self.part_cfg:
            new["base"] = mb_mod.set_goal(self.part_cfg["base"], ctrl_state.arm["base"],
                                          action[:, slice(*idx["base"])], self._base_yaw(kin))
        return RobotCtrlState(arm=new, gripper_action=st.gripper_action)

    def run_controllers(self, kin, M, bias, qpos, qvel, ctrl_state: RobotCtrlState, ctrl, substep=None):
        """The arms' and grippers' ctrl, then each part's, clipped to its
        actuators' ctrlrange."""
        ctrl = super().run_controllers(kin, M, bias, qpos, qvel, ctrl_state, ctrl, substep=substep)
        for part in ("torso", "head", "legs"):
            if part in self.part_cfg:
                d = self._part_dev[part]
                tau = jp_mod.run(self.part_cfg[part], ctrl_state.arm[part],
                                 self._part_view(kin, M, bias, qpos, qvel, part))
                ctrl[:, d["act"]] = torch.clamp(tau, d["lo"], d["hi"])
        if "base" in self.part_cfg:
            d = self._part_dev["base"]
            ctrl[:, d["act"]] = mb_mod.run(self.part_cfg["base"], ctrl_state.arm["base"], d["lo"], d["hi"])
        return ctrl


class LeggedRobot(MobileRobot):
    """A legged robot (the JAX robots/robot.py:796-891; robosuite
    robots/legged_robot.py:17-253): the legs' JOINT_POSITION part applies
    its goal at once (legged_robot.py:46-60), and a leg base that declares
    raw servo gains (Spot's leg_servo) drives the legs with that servo.

    As the JAX package does, and unlike robosuite, a delta leg command is
    anchored to the standing posture (the base's init_qpos), not to the
    current joints: robosuite re-anchors at the current position every
    policy step (joint_pos.py:224-226), so under a zero command gravity
    ratchets the stance down tick by tick; anchored, a zero action holds
    the stance. A legs part configured with absolute input takes raw joint
    goals instead."""

    def __init__(self, model, robot_model, controller_config=None):
        super().__init__(model, robot_model, controller_config)
        self._legs_anchor = self._legs_delta = None
        cfg = self.part_cfg.get("legs")
        servo = getattr(self.rm.base, "leg_servo", None)
        if cfg is not None and servo is not None:
            cfg = dataclasses.replace(cfg, raw_pd=True, kp=float(servo[0]), kd=float(servo[1]))
            self.part_cfg["legs"] = cfg
        liq = self.legs_init_qpos
        if cfg is not None and cfg.input_type == "delta" and liq is not None:
            dev = model.device
            self._legs_anchor = torch.as_tensor(liq, device=dev)
            self._legs_delta = tuple(torch.as_tensor(nums2array(v, cfg.dim), device=dev)
                                     for v in (cfg.input_min, cfg.input_max, cfg.output_min, cfg.output_max))
            # the part controller sees posture-anchored absolute goals
            self.part_cfg["legs"] = dataclasses.replace(cfg, input_type="absolute")

    def set_goals(self, kin, M, bias, qpos, qvel, ctrl_state: RobotCtrlState, action) -> RobotCtrlState:
        # under a whole-body composite the action has no legs slice
        idx = self.action_split_indexes()
        if self._legs_anchor is not None and "legs" in idx:
            s, e = idx["legs"]
            action = torch.cat([action[:, :s], self._legs_anchor + CU.scale_action(action[:, s:e], *self._legs_delta),
                                action[:, e:]], dim=-1)
        return super().set_goals(kin, M, bias, qpos, qvel, ctrl_state, action)

    @property
    def is_legs_actuated(self) -> bool:
        return len(self.part_actuator_ids["legs"]) > 0

    @property
    def num_leg_joints(self) -> int:
        return len(self.part_qpos_idx["legs"])

    @property
    def legs_init_qpos(self):
        """The legs' standing posture: the leg base's init_qpos (Spot), else
        the reset posture of the card's legs (GR1: init_qpos where it
        covers the card's joints, qpos0 elsewhere), else None (no legs: the
        floating and legless variants)."""
        base = self.rm.base
        if base.leg_joints and len(base.init_qpos):
            return np.asarray(base.init_qpos, dtype=np.float32)[:self.num_leg_joints]
        if self.num_leg_joints:
            iq = np.asarray(self.rm.init_qpos, dtype=np.float32)
            pos = {int(a): i for i, a in enumerate(self.init_qpos_idx)} if len(iq) == len(self.init_qpos_idx) else {}
            q0 = self.model.qpos0.cpu().numpy()
            return np.array([iq[pos[int(a)]] if int(a) in pos else q0[int(a)] for a in self.part_qpos_idx["legs"]],
                            dtype=np.float32)
        return None
