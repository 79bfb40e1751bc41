"""Operational Space Controller (OSC_POSE, and OSC_POSITION with
control_ori=False) on batched tensors (the JAX package's
controllers/parts/osc.py; robosuite controllers/parts/arm/osc.py).

  * set_goal (robosuite osc.py:225-283): delta actions scaled into the
    output range and applied to the achieved eef pose (or, with
    goal_update_mode "desired", to the previous goal), or absolute goals;
    in the base frame of the robot or the world frame (input_ref_frame);
    OSC_POSITION freezes the orientation goal at the current eef
    orientation. In a variable-impedance mode (robosuite osc.py:190-211)
    "variable" reads six damping ratios and six gains from the front of
    the arm's action, "variable_kp" six gains; both clip them to their
    limits and keep the per-scenario kp and kd in OSCState;
  * interpolation="linear" (robosuite utils/traj_utils.py, wired by
    controller_factory.py:118-133): the goal ramps from the previous one
    over the first interp_steps substeps of the policy step, linearly in
    position and by slerp in orientation; set_goal keeps the previous goal
    as OSCState.start_pos / start_ori, and the substep index is the
    interpolator's step;
  * run_world (osc.py:403-495): F = kp e + kd (v_base - v_ref),
    tau = J^T (Lambda F) + qfrc_bias + nullspace torques.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from robosuite_tpu_torch.controllers import control_utils as C
from robosuite_tpu_torch.controllers.base import ArmView, nums2array
from robosuite_tpu_torch.utils import transforms as T


IMPEDANCE_MODES = ("fixed", "variable", "variable_kp")


@dataclasses.dataclass(frozen=True)
class OSCConfig:
    control_ori: bool = True
    input_max: Any = 1.0
    input_min: Any = -1.0
    output_max: Any = (0.05, 0.05, 0.05, 0.5, 0.5, 0.5)
    output_min: Any = (-0.05, -0.05, -0.05, -0.5, -0.5, -0.5)
    kp: Any = 150.0
    damping_ratio: Any = 1.0
    impedance_mode: str = "fixed"
    kp_limits: Tuple[float, float] = (0.0, 300.0)
    damping_ratio_limits: Tuple[float, float] = (0.0, 100.0)
    policy_freq: int = 20
    input_type: str = "delta"
    input_ref_frame: str = "base"
    uncouple_pos_ori: bool = True
    interpolation: Optional[str] = None  # None | "linear"
    ramp_ratio: float = 0.2
    controller_freq: float = 500.0

    def __post_init__(self):
        if self.impedance_mode not in IMPEDANCE_MODES:
            raise ValueError(f"impedance_mode {self.impedance_mode!r}: one of {IMPEDANCE_MODES}")

    @property
    def interp_steps(self) -> int:
        """Substeps over which the goal ramps (robosuite traj_utils.py:63-66)."""
        return max(int(math.ceil(self.ramp_ratio * self.controller_freq / self.policy_freq)), 1)

    @property
    def base_dim(self) -> int:
        return 6 if self.control_ori else 3

    @property
    def control_dim(self) -> int:
        return self.base_dim + {"fixed": 0, "variable": 12, "variable_kp": 6}[self.impedance_mode]

    def arrays(self, device):
        def t(x, n):
            return torch.as_tensor(nums2array(x, n), device=device)

        d = self.base_dim
        return dict(input_max=t(self.input_max, d), input_min=t(self.input_min, d),
                    output_max=t(self.output_max, d), output_min=t(self.output_min, d),
                    kp=t(self.kp, 6), damping_ratio=t(self.damping_ratio, 6),
                    kp_min=t(self.kp_limits[0], 6), kp_max=t(self.kp_limits[1], 6),
                    dr_min=t(self.damping_ratio_limits[0], 6), dr_max=t(self.damping_ratio_limits[1], 6))


@dataclasses.dataclass
class OSCState:
    goal_pos: torch.Tensor   # (B, 3) in the controller's reference frame
    goal_ori: torch.Tensor   # (B, 3, 3) in the controller's reference frame
    kp: torch.Tensor         # (B, 6)
    kd: torch.Tensor         # (B, 6)
    # the interpolation's start: the previous goal, kept by set_goal (the
    # goal itself after init_state)
    start_pos: Optional[torch.Tensor] = None
    start_ori: Optional[torch.Tensor] = None


def _eef_pose_in_origin(view: ArmView):
    """robosuite osc.py:300-304: the eef pose in the base frame."""
    Rt = view.origin_ori.transpose(1, 2)
    pos = (Rt @ (view.ref_pos - view.origin_pos)[..., None])[..., 0]
    return pos, Rt @ view.ref_ori_mat


def _eef_pose(cfg: OSCConfig, view: ArmView):
    """The eef pose in the controller's reference frame."""
    if cfg.input_ref_frame == "base":
        return _eef_pose_in_origin(view)
    return view.ref_pos, view.ref_ori_mat


def init_state(cfg: OSCConfig, view: ArmView) -> OSCState:
    """The goal starts at the current pose (robosuite osc.py:306-350)."""
    arrs = cfg.arrays(view.ref_pos.device)
    B = view.ref_pos.shape[0]
    kp = arrs["kp"].expand(B, 6)
    kd = 2.0 * torch.sqrt(kp) * arrs["damping_ratio"]
    pos, ori = _eef_pose(cfg, view)
    return OSCState(goal_pos=pos, goal_ori=ori, kp=kp, kd=kd, start_pos=pos, start_ori=ori)


def set_goal(cfg: OSCConfig, state: OSCState, view: ArmView, action, goal_update_mode: str = "achieved",
             wrt_origin=None) -> OSCState:
    """robosuite osc.py:225-283 with compute_goal_pos / ori (:306-404): in a
    variable mode the gains first, from the front of the action, clipped to
    their limits: kd = 2 sqrt(kp) * the clipped damping ratio ("variable")
    or 2 sqrt(kp) ("variable_kp"). Delta input moves the achieved pose
    (goal_update_mode "achieved") or the previous goal ("desired"); a (B,)
    bool `wrt_origin` picks "desired" per scenario. Absolute input is the
    goal position and, for OSC_POSE, its axis-angle orientation; OSC_POSITION
    holds the current eef orientation. The previous goal becomes the
    interpolation's start."""
    arrs = cfg.arrays(action.device)
    kp, kd = state.kp, state.kd
    d = cfg.base_dim
    if cfg.impedance_mode == "variable":
        kp = torch.clamp(action[:, 6:12], arrs["kp_min"], arrs["kp_max"])
        kd = 2.0 * torch.sqrt(kp) * torch.clamp(action[:, 0:6], arrs["dr_min"], arrs["dr_max"])
        action = action[:, 12:]
    elif cfg.impedance_mode == "variable_kp":
        kp = torch.clamp(action[:, 0:6], arrs["kp_min"], arrs["kp_max"])
        kd = 2.0 * torch.sqrt(kp)
        action = action[:, 6:]
    if cfg.input_type == "delta":
        scaled = C.scale_action(action[:, :d], arrs["input_min"], arrs["input_max"],
                                arrs["output_min"], arrs["output_max"])
        ori_delta = scaled[:, 3:6] if cfg.control_ori else torch.zeros_like(scaled)
        cur_pos, cur_ori = _eef_pose(cfg, view)
        if wrt_origin is not None:
            base_pos = torch.where(wrt_origin[:, None], state.goal_pos, cur_pos)
            base_ori = torch.where(wrt_origin[:, None, None], state.goal_ori, cur_ori)
        elif goal_update_mode == "achieved":
            base_pos, base_ori = cur_pos, cur_ori
        else:
            base_pos, base_ori = state.goal_pos, state.goal_ori
        goal_pos = base_pos + scaled[:, 0:3]
        goal_ori = T.quat2mat(T.axisangle2quat(ori_delta)) @ base_ori
    else:  # absolute
        goal_pos = action[:, 0:3]
        goal_ori = T.quat2mat(T.axisangle2quat(action[:, 3:6])) if cfg.control_ori else _eef_pose(cfg, view)[1]
    return OSCState(goal_pos=goal_pos, goal_ori=goal_ori, kp=kp, kd=kd, start_pos=state.goal_pos,
                    start_ori=state.goal_ori)


def _interpolated_goal(cfg: OSCConfig, state: OSCState, substep):
    """The goal at substep `substep` of the policy step: linear in position,
    slerp in orientation (robosuite traj_utils.py:119-141)."""
    frac = min((substep + 1.0) / cfg.interp_steps, 1.0)
    pos = state.start_pos + (state.goal_pos - state.start_pos) * frac
    q = T.quat_slerp(T.mat2quat(state.start_ori), T.mat2quat(state.goal_ori), frac)
    return pos, T.quat2mat(q)


def desired_world_pose(cfg: OSCConfig, state: OSCState, origin_pos, origin_ori, substep=None):
    """The goal in the WORLD frame given the base-frame origin pose, at
    substep `substep` of the policy step under interpolation (None: the
    goal itself); the fused substep takes it as its goal input."""
    if cfg.interpolation == "linear" and substep is not None and state.start_pos is not None:
        goal_pos, goal_ori = _interpolated_goal(cfg, state, substep)
    else:
        goal_pos, goal_ori = state.goal_pos, state.goal_ori
    if cfg.input_ref_frame == "base":
        return origin_pos + (origin_ori @ goal_pos[..., None])[..., 0], origin_ori @ goal_ori
    return goal_pos, goal_ori


def run_world(cfg: OSCConfig, view: ArmView, desired_pos, desired_ori, kp, kd):
    """OSC torques for a world-frame desired pose (robosuite osc.py:437-495)."""
    ori_error = T.orientation_error(desired_ori, view.ref_ori_mat)
    position_error = desired_pos - view.ref_pos
    vel_pos_error = -(view.ref_pos_vel - view.origin_pos_vel)
    vel_ori_error = -(view.ref_ori_vel - view.origin_ori_vel)
    desired_force = position_error * kp[:, 0:3] + vel_pos_error * kd[:, 0:3]
    desired_torque = ori_error * kp[:, 3:6] + vel_ori_error * kd[:, 3:6]

    J_full = view.J_full
    # the operational-space inverses run in float64: at near-singular arm
    # poses float32 loses the digits the 1e-3 torque parity needs (the
    # CUDA substep computes this law in double too)
    lambda_full, lambda_pos, lambda_ori, nullspace_matrix = (x.to(J_full.dtype) for x in C.opspace_matrices(
        view.mass_matrix.double(), J_full.double(), view.J_pos.double(), view.J_ori.double()))
    if cfg.uncouple_pos_ori:
        wrench = torch.cat([(lambda_pos @ desired_force[..., None])[..., 0],
                            (lambda_ori @ desired_torque[..., None])[..., 0]], dim=-1)
    else:
        wrench = (lambda_full @ torch.cat([desired_force, desired_torque], dim=-1)[..., None])[..., 0]
    torques = (J_full.transpose(1, 2) @ wrench[..., None])[..., 0] + view.torque_compensation
    return torques + C.nullspace_torques(
        view.mass_matrix, nullspace_matrix, view.initial_joint, view.joint_pos, view.joint_vel
    )


def run(cfg: OSCConfig, state: OSCState, view: ArmView, substep=None):
    """robosuite osc.py:403-495 run_controller: joint torques; `substep`,
    the index within the policy step, drives the goal interpolation."""
    desired_pos, desired_ori = desired_world_pose(cfg, state, view.origin_pos, view.origin_ori, substep)
    return run_world(cfg, view, desired_pos, desired_ori, state.kp, state.kd)
