"""Inverse-kinematics controller (IK_POSE) on batched tensors (the JAX
package's controllers/parts/ik.py; robosuite controllers/parts/arm/ik.py
with utils/ik_utils.py): differential IK at policy rate giving joint
position goals, tracked at substep rate by the JOINT_POSITION law (as
robosuite's controller subclasses JointPositionController).

The solve is robosuite's compute_joint_positions (ik.py:209-302, the
single-site delta branch):

    dpos  = clip_translation(action[:3], ik_pos_limit)         (ik.py:476-508)
    dquat = clip_rotation(axisangle2quat(action[3:6]), ik_ori_limit)
    twist = [Kpos * dpos; Kori * rotvec(dquat)] / integration_dt
    dq    = J^T (J J^T + damping^2 I)^-1 twist                 (DLS)
    dq   += (I - pinv(J) J) Kn (q0 - q)                        (nullspace)
    dq   *= min(1, max_angvel / max|dq|)
    q_des = q + dq * integration_dt

It runs in float64, as the plain OSC's operational-space inverses do:
the exact-pinv projector (J J^T + 1e-8 I) loses most float32 digits near
a singular pose.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from robosuite_tpu_torch.controllers.base import ArmView
from robosuite_tpu_torch.controllers.parts import joint_pos as jp_mod
from robosuite_tpu_torch.ops import linalg
from robosuite_tpu_torch.utils import transforms as T

# robosuite ik.py:219's Kn (7-dof arms)
_KN_DEFAULT = (10.0, 10.0, 10.0, 10.0, 5.0, 5.0, 5.0)


@dataclasses.dataclass(frozen=True)
class IKConfig:
    dim: int = 7
    ik_pos_limit: float = 0.02        # translation clip (parts/ik_pose.json)
    ik_ori_limit: float = 0.05        # rotation-angle clip (rad)
    ik_damping: float = 5e-2          # the DLS lambda (damping_pseudo_inv)
    integration_dt: float = 0.1       # dq -> q_des (ik.py:227)
    Kpos: float = 0.95                # the twist's position gain (ik.py:216)
    Kori: float = 0.95                # and orientation gain
    max_angvel: float = 1.0           # the |dq| scale (velocity_limits[1])
    nullspace_gains: Optional[Tuple[float, ...]] = None  # per-joint Kn; None: _KN_DEFAULT resized
    kp: Any = 50.0                    # the inner joint-position tracking gains
    damping_ratio: Any = 1.0
    input_type: str = "delta"

    @property
    def control_dim(self) -> int:
        return 6

    def kn(self, n: int, device=None):
        """The nullspace gains of an n-joint arm (float32)."""
        kn = self.nullspace_gains[:n] if self.nullspace_gains is not None else (_KN_DEFAULT * ((n + 6) // 7))[:n]
        return torch.tensor(kn, dtype=torch.float32, device=device)

    def joint_cfg(self) -> jp_mod.JointPosConfig:
        """The inner JOINT_POSITION law, taking absolute goals."""
        return jp_mod.JointPosConfig(dim=self.dim, kp=self.kp, damping_ratio=self.damping_ratio,
                                     input_type="absolute")


@dataclasses.dataclass
class IKState:
    joint: jp_mod.JointPosState  # the inner JOINT_POSITION state


def init_state(cfg: IKConfig, view: ArmView) -> IKState:
    return IKState(joint=jp_mod.init_state(cfg.joint_cfg(), view))


def clip_ik_input(cfg: IKConfig, dpos, drot_aa):
    """robosuite _clip_ik_input (ik.py:476-508): the translation clipped to
    ik_pos_limit by norm; the axis-angle rotation as a quaternion whose
    angle 2 acos(w) is clipped to ik_ori_limit (clip_rotation,
    transform_utils.py:741-781). (B, 3), (B, 3) -> (dpos, dquat xyzw)."""
    nrm = torch.linalg.vector_norm(dpos, dim=-1, keepdim=True)
    dpos = torch.where(nrm > cfg.ik_pos_limit, dpos * (cfg.ik_pos_limit / (nrm + 1e-12)), dpos)
    q = T.axisangle2quat(drot_aa)
    den = torch.sqrt(torch.clamp_min(1.0 - q[..., 3:4] * q[..., 3:4], 0.0))
    axis = q[..., :3] / torch.clamp_min(den, 1e-12)
    ang = 2.0 * torch.arccos(torch.clamp(q[..., 3:4], -1.0, 1.0))
    half = torch.tensor(0.5 * cfg.ik_ori_limit, dtype=q.dtype, device=q.device)
    q_lim = torch.cat([axis * torch.sin(half), torch.cos(half).expand_as(den)], dim=-1)
    return dpos, torch.where((den > 0.0) & (torch.abs(ang) > cfg.ik_ori_limit), q_lim, q)


def solve_q_des(cfg: IKConfig, J, q, q0, dpos, drot_mat):
    """robosuite compute_joint_positions (ik.py:209-302, the single-site
    delta branch), in float64: J (B, 6, n) the eef site's Jacobian over the
    arm dofs, q (B, n) and q0 (n,) the current and initial joints, dpos
    (B, 3) the clipped translation, drot_mat (B, 3, 3) the relative rotation.
    -> q_des (B, n) in q's dtype."""
    dt = cfg.integration_dt
    J64, q64 = J.double(), q.double()
    # mju_mat2Quat + mju_quat2Vel: drot's rotation vector (2 acos(w) of a
    # small rotation keeps few float32 digits)
    w = T.quat2axisangle(T.mat2quat(drot_mat.double()))
    twist = torch.cat([cfg.Kpos * dpos.double() / dt, cfg.Kori * w / dt], dim=-1)
    JJt = J64 @ J64.transpose(-1, -2)
    eye = torch.eye(6, dtype=torch.float64, device=J.device)
    dq = (J64.transpose(-1, -2) @ linalg.chol_solve(linalg.chol_factor(JJt + cfg.ik_damping ** 2 * eye),
                                                      twist)[..., None])[..., 0]
    # the posture bias toward q0 through the EXACT pinv's projector (ik.py:292
    # `eye - pinv(jac) @ jac`): pinv(J) = J^T (J J^T)^-1 at full row rank, the
    # 1e-8 jitter only guarding an exact singularity
    dq_posture = cfg.kn(q.shape[-1], J.device).double() * (q0.double() - q64)
    proj = linalg.chol_solve(linalg.chol_factor(JJt + 1e-8 * eye), (J64 @ dq_posture[..., None])[..., 0])
    dq = dq + dq_posture - (J64.transpose(-1, -2) @ proj[..., None])[..., 0]
    if cfg.max_angvel > 0:
        dq = dq * torch.clamp_max(cfg.max_angvel / (torch.amax(torch.abs(dq), dim=-1, keepdim=True) + 1e-12), 1.0)
    return (q64 + dq * dt).to(q.dtype)


def set_goal(cfg: IKConfig, state: IKState, view: ArmView, action) -> IKState:
    dpos, dquat = clip_ik_input(cfg, action[:, :3], action[:, 3:6])
    q_des = solve_q_des(cfg, view.J_full, view.joint_pos, view.initial_joint, dpos, T.quat2mat(dquat))
    return IKState(joint=jp_mod.set_goal(cfg.joint_cfg(), state.joint, view, q_des))


def run(cfg: IKConfig, state: IKState, view: ArmView):
    return jp_mod.run(cfg.joint_cfg(), state.joint, view)
