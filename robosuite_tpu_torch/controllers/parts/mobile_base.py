"""Mobile-base joint-velocity controller on batched tensors (the JAX
package's controllers/parts/mobile_base.py; robosuite
controllers/parts/mobile_base/joint_vel.py:88-259).

The policy commands a base twist (forward, side, yaw) in the current base
frame; the planar base joints live in the base's initial frame, so set_goal
rotates the planar part by -(yaw - yaw0) (joint_vel.py:203-216), and run
writes the velocities onto the base's velocity actuators, rescaled to their
ctrlrange (joint_vel.py:250-256). The yaw angles are inputs: the robot layer
reads them from the base's centre site (mobile_base_controller.py:89-94).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from robosuite_tpu_torch.controllers.base import nums2array
from robosuite_tpu_torch.controllers.control_utils import scale_action


@dataclasses.dataclass(frozen=True)
class MobileBaseJointVelConfig:
    dim: int = 3  # forward, side, yaw
    input_max: Any = 1.0
    input_min: Any = -1.0
    output_max: Any = 1.0
    output_min: Any = -1.0

    @property
    def control_dim(self) -> int:
        return self.dim

    def arrays(self, device=None):
        def t(x):
            return torch.as_tensor(nums2array(x, self.dim), device=device)

        return dict(input_max=t(self.input_max), input_min=t(self.input_min), output_max=t(self.output_max),
                    output_min=t(self.output_min))


@dataclasses.dataclass
class MobileBaseState:
    goal_qvel: torch.Tensor  # (B, dim)
    init_yaw: torch.Tensor   # (B,) the base's yaw at the episode's start


def init_state(cfg: MobileBaseJointVelConfig, init_yaw) -> MobileBaseState:
    return MobileBaseState(goal_qvel=torch.zeros(init_yaw.shape[0], cfg.dim, dtype=init_yaw.dtype,
                                                 device=init_yaw.device), init_yaw=init_yaw)


def set_goal(cfg: MobileBaseJointVelConfig, state: MobileBaseState, action, cur_yaw) -> MobileBaseState:
    """robosuite joint_vel.py:159-220 (fixed impedance): action (B, dim),
    cur_yaw (B,)."""
    a = cfg.arrays(action.device)
    scaled = scale_action(action, a["input_min"], a["input_max"], a["output_min"], a["output_max"])
    theta = cur_yaw - state.init_yaw
    c, s = torch.cos(theta), torch.sin(theta)
    x, y = scaled[:, 0], scaled[:, 1]
    goal = torch.cat([torch.stack([x * c + y * s, -x * s + y * c], dim=-1), scaled[:, 2:]], dim=-1)
    return MobileBaseState(goal_qvel=goal, init_yaw=state.init_yaw)


def run(cfg: MobileBaseJointVelConfig, state: MobileBaseState, actuator_min, actuator_max):
    """The base velocity actuators' ctrl (B, dim) (joint_vel.py:222-259)."""
    return 0.5 * (actuator_max + actuator_min) + 0.5 * (actuator_max - actuator_min) * state.goal_qvel
