"""Physics state and forward-kinematics products, batched (batch is dim 0).

Counterpart of the JAX package's physics/state.py. The flattened
(time, qpos, qvel) layout is MjSimState's (robosuite binding_utils.py
MjSimState.from_flattened/flatten).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class State:
    """Integrator state: qpos (B, nq), qvel (B, nv), time (B,)."""

    qpos: torch.Tensor
    qvel: torch.Tensor
    time: torch.Tensor

    def flatten(self):
        return torch.cat([self.time[..., None], self.qpos, self.qvel], dim=-1)

    @classmethod
    def from_flattened(cls, arr, model):
        nq, nv = model.nq, model.nv
        return cls(time=arr[..., 0], qpos=arr[..., 1:1 + nq], qvel=arr[..., 1 + nq:1 + nq + nv])


@dataclasses.dataclass
class KinData:
    """Forward-kinematics products (world frame). Spatial vectors are
    (angular, linear) referenced at the world origin; sdof_* is the per-dof
    motion subspace. Shapes carry a leading batch dim."""

    xpos: torch.Tensor       # (B, nbody, 3)
    xquat: torch.Tensor      # (B, nbody, 4) wxyz
    xmat: torch.Tensor       # (B, nbody, 3, 3)
    xipos: torch.Tensor      # (B, nbody, 3) body COM
    ximat: torch.Tensor      # (B, nbody, 3, 3) inertial frame
    sdof_ang: torch.Tensor   # (B, nv, 3)
    sdof_lin: torch.Tensor   # (B, nv, 3)
    geom_xpos: torch.Tensor  # (B, ngeom, 3)
    geom_xmat: torch.Tensor  # (B, ngeom, 3, 3)
    site_xpos: torch.Tensor  # (B, nsite, 3)
    site_xmat: torch.Tensor  # (B, nsite, 3, 3)
    # (B, npair) min distance per candidate pair; set only on the planning
    # rollout's pose-only KinData (the fused substep's aux output), whose
    # contact queries read it instead of running the narrowphase
    pair_dist: Optional[torch.Tensor] = None
