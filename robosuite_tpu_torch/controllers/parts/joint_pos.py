"""Joint position controller (JOINT_POSITION) on batched tensors (the JAX
package's controllers/parts/joint_pos.py; robosuite
controllers/parts/generic/joint_pos.py:195-272).

  * set_goal: delta actions scaled into the output range and added to the
    current joint positions (or absolute joint targets), with fixed,
    variable or variable_kp impedance;
  * run: tau = M (kp e - kd qdot) + qfrc_bias (torque compensation), or
    the raw servo tau = kp e - kd qdot (+ bias) with raw_pd.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from robosuite_tpu_torch.controllers import control_utils as C
from robosuite_tpu_torch.controllers.base import ArmView, nums2array


@dataclasses.dataclass(frozen=True)
class JointPosConfig:
    dim: int = 7
    input_max: Any = 1.0
    input_min: Any = -1.0
    output_max: Any = 0.05
    output_min: Any = -0.05
    kp: Any = 50.0
    damping_ratio: Any = 1.0
    impedance_mode: str = "fixed"
    kp_limits: Tuple[float, float] = (0.0, 300.0)
    damping_ratio_limits: Tuple[float, float] = (0.0, 100.0)
    input_type: str = "delta"
    use_torque_compensation: bool = True
    # the raw position servo (no mass-matrix shaping): the law of a
    # model's <position kp kv> actuator class
    raw_pd: bool = False
    kd: Optional[Any] = None  # raw_pd: explicit kv (None -> 2 sqrt(kp) damping_ratio)

    @property
    def control_dim(self) -> int:
        d = self.dim
        if self.impedance_mode == "variable":
            d += 2 * self.dim
        elif self.impedance_mode == "variable_kp":
            d += self.dim
        return d

    def arrays(self, device=None):
        d = self.dim

        def t(x):
            return torch.as_tensor(nums2array(x, d), device=device)

        return dict(input_max=t(self.input_max), input_min=t(self.input_min), output_max=t(self.output_max),
                    output_min=t(self.output_min), kp_min=t(self.kp_limits[0]), kp_max=t(self.kp_limits[1]),
                    dr_min=t(self.damping_ratio_limits[0]), dr_max=t(self.damping_ratio_limits[1]))


@dataclasses.dataclass
class JointPosState:
    goal_qpos: torch.Tensor  # (B, dim)
    kp: torch.Tensor         # (B, dim)
    kd: torch.Tensor         # (B, dim)


def init_state(cfg: JointPosConfig, view: ArmView) -> JointPosState:
    """The goal starts at the current joint positions."""
    B, dev = view.joint_pos.shape[0], view.joint_pos.device
    kp = torch.as_tensor(nums2array(cfg.kp, cfg.dim), device=dev)
    if cfg.kd is not None:
        kd = torch.as_tensor(nums2array(cfg.kd, cfg.dim), device=dev)
    else:
        kd = 2.0 * torch.sqrt(kp) * torch.as_tensor(nums2array(cfg.damping_ratio, cfg.dim), device=dev)
    return JointPosState(goal_qpos=view.joint_pos, kp=kp.expand(B, cfg.dim), kd=kd.expand(B, cfg.dim))


def set_goal(cfg: JointPosConfig, state: JointPosState, view: ArmView, action) -> JointPosState:
    """robosuite joint_pos.py:195-231: the new goal (and, with variable
    impedance, the gains) from a (B, control_dim) action."""
    arrs = cfg.arrays(action.device)
    kp, kd = state.kp, state.kd
    n = cfg.dim
    if cfg.input_type == "delta":
        if cfg.impedance_mode == "variable":
            damping_ratio, kp_in, delta = action[:, :n], action[:, n:2 * n], action[:, 2 * n:]
            kp = torch.clamp(kp_in, arrs["kp_min"], arrs["kp_max"])
            kd = 2.0 * torch.sqrt(kp) * torch.clamp(damping_ratio, arrs["dr_min"], arrs["dr_max"])
        elif cfg.impedance_mode == "variable_kp":
            kp_in, delta = action[:, :n], action[:, n:]
            kp = torch.clamp(kp_in, arrs["kp_min"], arrs["kp_max"])
            kd = 2.0 * torch.sqrt(kp)
        else:
            delta = action
        scaled = C.scale_action(delta, arrs["input_min"], arrs["input_max"], arrs["output_min"],
                                arrs["output_max"])
        goal = view.joint_pos + scaled
    else:
        goal = action
    return JointPosState(goal_qpos=goal, kp=kp, kd=kd)


def run(cfg: JointPosConfig, state: JointPosState, view: ArmView):
    """robosuite joint_pos.py:233-272 run_controller: joint torques (B, dim)."""
    desired = (state.goal_qpos - view.joint_pos) * state.kp - view.joint_vel * state.kd
    if cfg.raw_pd:
        return desired + view.torque_compensation if cfg.use_torque_compensation else desired
    if cfg.use_torque_compensation:
        return (view.mass_matrix @ desired[..., None])[..., 0] + view.torque_compensation
    return desired
