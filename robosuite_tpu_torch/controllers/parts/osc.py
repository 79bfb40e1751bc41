"""Operational Space Controller (OSC_POSE) on batched tensors (the JAX
package's controllers/parts/osc.py; robosuite controllers/parts/arm/osc.py).

  * set_goal (robosuite osc.py:225-283): delta actions scaled into the
    output range and applied to the achieved eef pose in the base frame;
  * run_world (osc.py:403-495): F = kp e + kd (v_base - v_ref),
    tau = J^T (Lambda F) + qfrc_bias + nullspace torques.

The port covers delta input in the base reference frame with no goal
interpolation, at fixed impedance or with the variable-impedance modes
(robosuite osc.py:190-211, 225-245): "variable" reads six damping ratios
and six gains from the front of the arm's action, "variable_kp" six
gains; both clip them to their limits and keep the per-scenario kp and kd
in OSCState. Other settings raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
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
    input_type: str = "delta"
    input_ref_frame: str = "base"
    uncouple_pos_ori: bool = True
    interpolation: Optional[str] = None

    def __post_init__(self):
        if self.impedance_mode not in IMPEDANCE_MODES:
            raise ValueError(f"impedance_mode {self.impedance_mode!r}: one of {IMPEDANCE_MODES}")
        if (self.input_type != "delta" or self.input_ref_frame != "base" or self.interpolation is not None
                or not self.control_ori):
            raise NotImplementedError(
                "the port's OSC covers OSC_POSE with delta input, base frame, no interpolation"
            )

    @property
    def control_dim(self) -> int:
        return 6 + {"fixed": 0, "variable": 12, "variable_kp": 6}[self.impedance_mode]

    def arrays(self, device):
        def t(x, n):
            return torch.as_tensor(nums2array(x, n), device=device)

        return dict(input_max=t(self.input_max, 6), input_min=t(self.input_min, 6),
                    output_max=t(self.output_max, 6), output_min=t(self.output_min, 6),
                    kp=t(self.kp, 6), damping_ratio=t(self.damping_ratio, 6),
                    kp_min=t(self.kp_limits[0], 6), kp_max=t(self.kp_limits[1], 6),
                    dr_min=t(self.damping_ratio_limits[0], 6), dr_max=t(self.damping_ratio_limits[1], 6))


@dataclasses.dataclass
class OSCState:
    goal_pos: torch.Tensor   # (B, 3) in the base frame
    goal_ori: torch.Tensor   # (B, 3, 3) in the base frame
    kp: torch.Tensor         # (B, 6)
    kd: torch.Tensor         # (B, 6)


def _eef_pose_in_origin(view: ArmView):
    """robosuite osc.py:300-304: the eef pose in the base frame."""
    Rt = view.origin_ori.transpose(1, 2)
    pos = (Rt @ (view.ref_pos - view.origin_pos)[..., None])[..., 0]
    return pos, Rt @ view.ref_ori_mat


def init_state(cfg: OSCConfig, view: ArmView) -> OSCState:
    """The goal starts at the current pose (robosuite osc.py:306-350)."""
    arrs = cfg.arrays(view.ref_pos.device)
    B = view.ref_pos.shape[0]
    kp = arrs["kp"].expand(B, 6)
    kd = 2.0 * torch.sqrt(kp) * arrs["damping_ratio"]
    pos, ori = _eef_pose_in_origin(view)
    return OSCState(goal_pos=pos, goal_ori=ori, kp=kp, kd=kd)


def set_goal(cfg: OSCConfig, state: OSCState, view: ArmView, action) -> OSCState:
    """robosuite osc.py:225-283: goal = achieved pose (+ scaled delta); in
    a variable mode the gains first, from the front of the action, clipped
    to their limits: kd = 2 sqrt(kp) * the clipped damping ratio
    ("variable") or 2 sqrt(kp) ("variable_kp")."""
    arrs = cfg.arrays(action.device)
    kp, kd = state.kp, state.kd
    if cfg.impedance_mode == "variable":
        kp = torch.clamp(action[:, 6:12], arrs["kp_min"], arrs["kp_max"])
        kd = 2.0 * torch.sqrt(kp) * torch.clamp(action[:, 0:6], arrs["dr_min"], arrs["dr_max"])
        action = action[:, 12:]
    elif cfg.impedance_mode == "variable_kp":
        kp = torch.clamp(action[:, 0:6], arrs["kp_min"], arrs["kp_max"])
        kd = 2.0 * torch.sqrt(kp)
        action = action[:, 6:]
    scaled = C.scale_action(action[:, :6], arrs["input_min"], arrs["input_max"],
                            arrs["output_min"], arrs["output_max"])
    cur_pos, cur_ori = _eef_pose_in_origin(view)
    goal_pos = cur_pos + scaled[:, 0:3]
    goal_ori = T.quat2mat(T.axisangle2quat(scaled[:, 3:6])) @ cur_ori
    return OSCState(goal_pos=goal_pos, goal_ori=goal_ori, kp=kp, kd=kd)


def desired_world_pose(cfg: OSCConfig, state: OSCState, origin_pos, origin_ori):
    """The goal in the WORLD frame given the base-frame origin pose; the
    fused substep takes it as its goal input."""
    pos = origin_pos + (origin_ori @ state.goal_pos[..., None])[..., 0]
    return pos, origin_ori @ state.goal_ori


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


def run(cfg: OSCConfig, state: OSCState, view: ArmView):
    """robosuite osc.py:403-495 run_controller: joint torques."""
    desired_pos, desired_ori = desired_world_pose(cfg, state, view.origin_pos, view.origin_ori)
    return run_world(cfg, view, desired_pos, desired_ori, state.kp, state.kd)
