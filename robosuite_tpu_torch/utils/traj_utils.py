"""Linear goal interpolation on batched tensors (the JAX package's
utils/traj_utils.py; robosuite utils/traj_utils.py:25-141,
LinearInterpolator): the interpolator's start, goal and step are explicit
state. Positions ramp linearly; orientations by slerp, given as euler
angles ("euler") or xyzw quaternions ("quat").
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from robosuite_tpu_torch.utils import transforms as T


@dataclasses.dataclass(frozen=True)
class LinearInterpolatorConfig:
    ndim: int
    controller_freq: float = 500.0
    policy_freq: float = 20.0
    ramp_ratio: float = 0.2
    ori_interpolate: Optional[str] = None  # None | "euler" | "quat"

    @property
    def total_steps(self) -> int:
        """robosuite traj_utils.py:63-66."""
        return max(int(math.ceil(self.ramp_ratio * self.controller_freq / self.policy_freq)), 1)


@dataclasses.dataclass
class LinearInterpolatorState:
    start: torch.Tensor  # (B, ndim), or (B, 4) quaternions
    goal: torch.Tensor
    step: torch.Tensor   # (B,) int32


def init_state(cfg: LinearInterpolatorConfig, batch: int, device=None) -> LinearInterpolatorState:
    """`batch` interpolators at rest at zero (the identity quaternion)."""
    if cfg.ori_interpolate == "quat":
        z = torch.tensor([0.0, 0.0, 0.0, 1.0], device=device).expand(batch, 4)
    else:
        z = torch.zeros(batch, cfg.ndim, device=device)
    return LinearInterpolatorState(start=z, goal=z, step=torch.zeros(batch, dtype=torch.int32, device=device))


def set_goal(cfg: LinearInterpolatorConfig, state: LinearInterpolatorState, goal) -> LinearInterpolatorState:
    """robosuite traj_utils.py:101-117: start <- the previous goal, step <- 0."""
    return LinearInterpolatorState(start=state.goal, goal=goal, step=torch.zeros_like(state.step))


def get_interpolated_goal(cfg: LinearInterpolatorConfig, state: LinearInterpolatorState):
    """robosuite traj_utils.py:119-141: -> (the goal at this step, the state
    a step on)."""
    frac = torch.clamp_max((state.step + 1).to(state.start.dtype) / cfg.total_steps, 1.0)
    if cfg.ori_interpolate == "euler":
        q = T.quat_slerp(T.mat2quat(T.euler2mat(state.start)), T.mat2quat(T.euler2mat(state.goal)), frac)
        out = T.mat2euler(T.quat2mat(q))
    elif cfg.ori_interpolate == "quat":
        out = T.quat_slerp(state.start, state.goal, frac)
    else:
        out = state.start + (state.goal - state.start) * frac[:, None]
    return out, dataclasses.replace(state, step=state.step + 1)
