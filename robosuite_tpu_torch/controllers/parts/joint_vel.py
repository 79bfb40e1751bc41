"""Joint velocity controller (JOINT_VELOCITY) on batched tensors (the JAX
package's controllers/parts/joint_vel.py; robosuite
controllers/parts/generic/joint_vel.py:140-210): a PID on the joint
velocities with anti-windup, plus gravity compensation. The PID history
(last error, the derivative window, summed error, the saturation flag) is
explicit state, which `run` returns beside the torques.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from robosuite_tpu_torch.controllers import control_utils as C
from robosuite_tpu_torch.controllers.base import ArmView, nums2array


@dataclasses.dataclass(frozen=True)
class JointVelConfig:
    dim: int = 7
    input_max: Any = 1.0
    input_min: Any = -1.0
    output_max: Any = 1.0
    output_min: Any = -1.0
    kp: Any = 0.25
    ki: Any = 0.0
    kd: Any = 0.0
    velocity_limits: Optional[Tuple[float, float]] = None
    derr_window: int = 5

    @property
    def control_dim(self) -> int:
        return self.dim

    def arrays(self, device=None):
        d = self.dim

        def t(x):
            return torch.as_tensor(nums2array(x, d), device=device)

        return dict(input_max=t(self.input_max), input_min=t(self.input_min), output_max=t(self.output_max),
                    output_min=t(self.output_min), kp=t(self.kp), ki=t(self.ki), kd=t(self.kd))


@dataclasses.dataclass
class JointVelState:
    goal_vel: torch.Tensor    # (B, dim)
    last_err: torch.Tensor    # (B, dim)
    derr_buf: torch.Tensor    # (B, window, dim): the last errors' differences, newest first
    summed_err: torch.Tensor  # (B, dim)
    saturated: torch.Tensor   # (B,) bool: the last torques were clipped


def init_state(cfg: JointVelConfig, view: ArmView) -> JointVelState:
    B, dev = view.joint_pos.shape[0], view.joint_pos.device
    z = torch.zeros(B, cfg.dim, device=dev)
    return JointVelState(goal_vel=z, last_err=z, derr_buf=torch.zeros(B, cfg.derr_window, cfg.dim, device=dev),
                         summed_err=z, saturated=torch.zeros(B, dtype=torch.bool, device=dev))


def set_goal(cfg: JointVelConfig, state: JointVelState, view: ArmView, action) -> JointVelState:
    """The goal velocities: the action scaled into the output range, then
    clipped to velocity_limits."""
    arrs = cfg.arrays(action.device)
    goal = C.scale_action(action, arrs["input_min"], arrs["input_max"], arrs["output_min"], arrs["output_max"])
    if cfg.velocity_limits is not None:
        goal = torch.clamp(goal, cfg.velocity_limits[0], cfg.velocity_limits[1])
    return dataclasses.replace(state, goal_vel=goal)


def run(cfg: JointVelConfig, state: JointVelState, view: ArmView, actuator_min=None, actuator_max=None):
    """robosuite joint_vel.py:165-210 run_controller: -> (torques (B, dim),
    the next state). The sum of errors stops growing while the torques
    saturate at the actuator limits."""
    arrs = cfg.arrays(view.joint_vel.device)
    err = state.goal_vel - view.joint_vel
    derr_buf = torch.cat([(err - state.last_err)[:, None], state.derr_buf[:, :-1]], dim=1)
    summed = torch.where(state.saturated[:, None], state.summed_err, state.summed_err + err)
    torques = (arrs["kp"] * err + arrs["ki"] * summed + arrs["kd"] * torch.mean(derr_buf, dim=1)
               + view.torque_compensation)
    if actuator_min is not None:
        clipped = torch.clamp(torques, actuator_min, actuator_max)
        saturated = torch.sum(torch.abs(clipped - torques), dim=-1) != 0
    else:
        clipped, saturated = torques, torch.zeros_like(state.saturated)
    return clipped, JointVelState(goal_vel=state.goal_vel, last_err=err, derr_buf=derr_buf, summed_err=summed,
                                  saturated=saturated)
