"""Joint torque controller (JOINT_TORQUE) on batched tensors (the JAX
package's controllers/parts/joint_tor.py; robosuite
controllers/parts/generic/joint_tor.py:60-165): the action scaled into
the output range and clipped to the arm's torque limits at policy rate,
plus gravity compensation at substep rate.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from robosuite_tpu_torch.controllers import control_utils as C
from robosuite_tpu_torch.controllers.base import ArmView, nums2array


@dataclasses.dataclass(frozen=True)
class JointTorConfig:
    dim: int = 7
    input_max: Any = 1.0
    input_min: Any = -1.0
    output_max: Any = 0.05
    output_min: Any = -0.05
    use_torque_compensation: bool = True

    @property
    def control_dim(self) -> int:
        return self.dim

    def arrays(self, device=None):
        d = self.dim

        def t(x):
            return torch.as_tensor(nums2array(x, d), device=device)

        return dict(input_max=t(self.input_max), input_min=t(self.input_min), output_max=t(self.output_max),
                    output_min=t(self.output_min))


@dataclasses.dataclass
class JointTorState:
    goal_torque: torch.Tensor  # (B, dim)


def init_state(cfg: JointTorConfig, view: ArmView) -> JointTorState:
    return JointTorState(goal_torque=torch.zeros(view.joint_pos.shape[0], cfg.dim, device=view.joint_pos.device))


def set_goal(cfg: JointTorConfig, state: JointTorState, action, torque_min, torque_max) -> JointTorState:
    arrs = cfg.arrays(action.device)
    goal = C.scale_action(action, arrs["input_min"], arrs["input_max"], arrs["output_min"], arrs["output_max"])
    return JointTorState(goal_torque=torch.clamp(goal, torque_min, torque_max))


def run(cfg: JointTorConfig, state: JointTorState, view: ArmView):
    if cfg.use_torque_compensation:
        return state.goal_torque + view.torque_compensation
    return state.goal_torque
