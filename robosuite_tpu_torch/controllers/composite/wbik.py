"""Whole-body differential IK, the WHOLE_BODY_IK composite controller (the
JAX package's controllers/composite/wbik.py; robosuite
composite_controller.py:514-589 with utils/ik_utils.py:15-340), on batched
stacked site Jacobians:

    twist_i = [Kpos (p*_i - p_i); Kori rotvec(R*_i R_i^T)] / dt
    dq      = J^T (J J^T + damping^2 I)^-1 twist            (damped LSQ)
    dq     += Kn (q0 - q) - J^T (J J^T + damping^2 I)^-1 J Kn (q0 - q)
    dq     *= min(1, max_dq / max|dq|); torso dofs scaled to max_dq_torso
    q_des   = q + dq dt

solved jointly over every selected dof (the torso and all arms); q_des's
slices become the parts' JOINT_POSITION goals. The solve runs in float64,
as the port's IK_POSE does (the JAX package solves in float32).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from robosuite_tpu_torch.ops import linalg
from robosuite_tpu_torch.utils import transforms as T


@dataclasses.dataclass(frozen=True)
class WBIKConfig:
    """composite_controller_specific_configs (default_*_whole_body_ik.json)."""

    damping: float = 5e-2            # ik_pseudo_inverse_damping
    integration_dt: float = 0.1      # ik_integration_dt
    max_dq: float = 4.0              # ik_max_dq
    max_dq_torso: float = 0.2        # ik_max_dq_torso
    Kpos: float = 0.95
    Kori: float = 0.95
    nullspace_gains: Tuple[float, ...] = ()  # Kn, one per selected dof (empty: ones)
    torso_mask: Tuple[float, ...] = ()       # 1.0 where the dof is a torso joint
    # ik_input_type: "absolute", targets in the base frame; "delta", about the current pose
    input_type: str = "absolute"


def wbik_solve(cfg: WBIKConfig, J, q, q0, site_pos, site_mat, target_pos, target_mat):
    """One differential-IK solve. J (B, 6S, n): each site's [jacp; jacr]
    over the selected dofs, stacked; q (B, n) and q0 (n,) the current and
    posture joints; site_pos (B, S, 3) / site_mat (B, S, 3, 3) the sites'
    poses, target_pos / target_mat their targets (world). -> q_des (B, n)
    in q's dtype."""
    dt = cfg.integration_dt
    d = torch.float64
    J, q64 = J.to(d), q.to(d)
    B, S = site_pos.shape[:2]
    dx = cfg.Kpos * (target_pos.to(d) - site_pos.to(d)) / dt
    # the rotation error as a rotation vector (mju_quat2Vel)
    w = T.quat2axisangle(T.mat2quat(target_mat.to(d) @ site_mat.to(d).transpose(-1, -2))) * (cfg.Kori / dt)
    twist = torch.cat([dx, w], dim=-1).reshape(B, 6 * S)
    Jt = J.transpose(-1, -2)
    L = linalg.chol_factor(J @ Jt + cfg.damping ** 2 * torch.eye(6 * S, dtype=d, device=J.device))
    dq = (Jt @ linalg.chol_solve(L, twist)[..., None])[..., 0]
    # the posture term projected onto null(J) by the damped projector (the
    # JAX package's; robosuite uses the exact pinv, ik_utils.py:313)
    n = q.shape[-1]
    kn = torch.tensor(cfg.nullspace_gains or (1.0,) * n, dtype=d, device=J.device)
    posture = kn * (q0.to(d) - q64)
    dq = dq + posture - (Jt @ linalg.chol_solve(L, (J @ posture[..., None])[..., 0])[..., None])[..., 0]
    if cfg.max_dq > 0:
        dq = dq * torch.clamp_max(cfg.max_dq / (torch.amax(torch.abs(dq), dim=-1, keepdim=True) + 1e-9), 1.0)
    if cfg.torso_mask and cfg.max_dq_torso > 0:
        tm = torch.tensor(cfg.torso_mask, dtype=d, device=J.device)
        tscale = torch.clamp_max(cfg.max_dq_torso / (torch.amax(torch.abs(dq * tm), dim=-1, keepdim=True) + 1e-9),
                                 1.0)
        dq = dq * (tm * tscale + (1.0 - tm))
    return (q64 + dq * dt).to(q.dtype)
