"""CRBA mass matrix, RNEA bias and passive joint forces on batched tensors
(the JAX package's physics/dynamics.py; MuJoCo mj_crb / mj_rne).

Together with kinematics.fk this is the plain version of the forward
kernel (ops/forward.py). The numerics follow the JAX package: CRBA
references every column d at its own body origin p_d, RNEA references the
scene's mass centroid, both to keep the float32 sums entry-scaled.
"""

from __future__ import annotations

import numpy as np
import torch

from robosuite_tpu_torch.models import spec as S


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b)


def body_ancestor_matrix(model):
    """anc[i, j] = 1 if body i is an ancestor of (or equal to) body j."""
    nb = model.nbody
    anc = np.zeros((nb, nb), dtype=np.float32)
    for j in range(nb):
        k = j
        while True:
            anc[k, j] = 1.0
            if k == 0:
                break
            k = model.body_parentid[k]
    return anc


def moving_bodies(model):
    """Bodies moved by at least one dof (the rest never enter M)."""
    out = []
    for b in range(model.nbody):
        k = b
        while k != 0:
            if model.body_jntnum[k] > 0:
                out.append(b)
                break
            k = model.body_parentid[k]
    return out


def crba(model, kin, mass=None, inertia=None, armature=None):
    """Composite-rigid-body mass matrix (B, nv, nv) incl. armature.
    mass/inertia/armature default to the model's (B-broadcast) leaves."""
    mass = model.body_mass if mass is None else mass
    inertia = model.body_inertia if inertia is None else inertia
    armature = model.dof_armature if armature is None else armature
    B = kin.xpos.shape[0]
    mass = mass.expand(B, -1)
    inertia = inertia.expand(B, -1, 3)
    dof_body = list(model.dof_bodyid)
    moving = moving_bodies(model)
    m = mass[:, moving]                                            # (B, nb)
    c = kin.xipos[:, moving]                                       # (B, nb, 3)
    R = kin.ximat[:, moving]
    I_C = torch.einsum("bnij,bnj,bnkj->bnik", R, inertia[:, moving], R)

    p = kin.xpos[:, dof_body]                                      # (B, nv, 3)
    s_ang = kin.sdof_ang
    s_lin_p = kin.sdof_lin + _cross(s_ang, p)
    sub = model.ancestor_mask.T[:, moving]                         # (nv, nb)

    r = c[:, None, :, :] - p[:, :, None, :]                        # (B, nv, nb, 3)
    v_com = s_lin_p[:, :, None, :] + _cross(s_ang[:, :, None, :], r)
    mw = m[:, None, :, None] * sub[None, :, :, None]
    f_lin = mw * v_com
    f_ang = torch.einsum("bnij,bdj->bdni", I_C, s_ang) * sub[None, :, :, None] + _cross(r, f_lin)
    F_lin = f_lin.sum(dim=2)                                       # (B, nv, 3)
    F_ang = f_ang.sum(dim=2)

    # M[e, d] = ang_e . F_ang_d + lin_e(p_d) . F_lin_d
    lin_e_pd = kin.sdof_lin[:, :, None, :] + _cross(s_ang[:, :, None, :], p[:, None, :, :])  # (B, e, d, 3)
    A = s_ang @ F_ang.transpose(1, 2) + torch.einsum("bedi,bdi->bed", lin_e_pd, F_lin)

    AM = model.ancestor_mask[dof_body, :].T                        # e ancestor-dof of body(d)
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    M = torch.where(AM > 0, A, torch.where(AM.T > 0, A.transpose(1, 2), zero))
    return M + torch.diag_embed(armature.expand(B, -1))


def rnea_bias(model, kin, qvel, mass=None, inertia=None, gravity=None):
    """qfrc_bias = C(q, qvel) qvel + G(q) (B, nv): inverse dynamics at
    qacc = 0, centroid-referenced."""
    mass = model.body_mass if mass is None else mass
    inertia = model.body_inertia if inertia is None else inertia
    gravity = model.gravity if gravity is None else gravity
    B = qvel.shape[0]
    m = mass.expand(B, -1)
    inertia = inertia.expand(B, -1, 3)
    gravity = gravity.expand(B, 3)
    o = torch.sum(m[:, :, None] * kin.xipos, dim=1) / torch.sum(m, dim=1, keepdim=True)
    sd_lin = kin.sdof_lin + _cross(kin.sdof_ang, o[:, None, :])
    c = kin.xipos - o[:, None, :]

    R = kin.ximat
    I_C = torch.einsum("bnij,bnj,bnkj->bnik", R, inertia, R)
    cc = c[..., :, None] * c[..., None, :]
    c2 = torch.sum(c * c, dim=-1)
    eye = torch.eye(3, dtype=c.dtype, device=c.device)
    I_O = I_C + m[..., None, None] * (c2[..., None, None] * eye - cc)
    h = m[..., None] * c
    anc_b = torch.as_tensor(body_ancestor_matrix(model), dtype=c.dtype, device=c.device)
    amask = model.ancestor_mask

    v_ang = amask @ (kin.sdof_ang * qvel[..., None])
    v_lin = amask @ (sd_lin * qvel[..., None])

    dof_body = list(model.dof_bodyid)
    vb_ang, vb_lin = v_ang[:, dof_body], v_lin[:, dof_body]
    sdot_ang = _cross(vb_ang, kin.sdof_ang)
    sdot_lin = _cross(vb_ang, sd_lin) + _cross(vb_lin, kin.sdof_ang)
    fixed_axis = np.ones(model.nv, dtype=np.float32)
    for j in range(model.njnt):
        if model.jnt_type[j] == S.FREE:
            fixed_axis[model.jnt_dofadr[j]:model.jnt_dofadr[j] + 3] = 0.0  # world-fixed axes: Sdot = 0
    fa = torch.as_tensor(fixed_axis, dtype=c.dtype, device=c.device)[:, None]
    sdot_ang = sdot_ang * fa
    sdot_lin = sdot_lin * fa

    a_ang = amask @ (sdot_ang * qvel[..., None])
    a_lin = amask @ (sdot_lin * qvel[..., None]) - gravity[:, None, :]

    def imul(x_ang, x_lin):
        lin = m[..., None] * x_lin + _cross(x_ang, h)
        ang = torch.einsum("bnij,bnj->bni", I_O, x_ang) + _cross(h, x_lin)
        return ang, lin

    Ia_ang, Ia_lin = imul(a_ang, a_lin)
    Iv_ang, Iv_lin = imul(v_ang, v_lin)
    f_ang = Ia_ang + _cross(v_ang, Iv_ang) + _cross(v_lin, Iv_lin)
    f_lin = Ia_lin + _cross(v_ang, Iv_lin)

    ft_ang = anc_b @ f_ang
    ft_lin = anc_b @ f_lin
    return torch.sum(kin.sdof_ang * ft_ang[:, dof_body], dim=-1) + torch.sum(sd_lin * ft_lin[:, dof_body], dim=-1)


def scalar_joint_index(model):
    """(qadr, dadr, jids) of all 1-dof (hinge/slide) joints."""
    jids = [j for j in range(model.njnt) if model.jnt_type[j] in (S.HINGE, S.SLIDE)]
    return [model.jnt_qposadr[j] for j in jids], [model.jnt_dofadr[j] for j in jids], jids


def scalar_joint_tensors(model):
    """scalar_joint_index as index tensors on the model's device."""
    return model.derived("scalar_joints", lambda: tuple(
        torch.tensor(v, dtype=torch.long, device=model.device) for v in scalar_joint_index(model)))


def passive_forces(model, qpos, qvel):
    """Joint springs qfrc = -stiffness (qpos - springref); damping is
    integrated implicitly by the engine."""
    qadr, dadr, jids = scalar_joint_tensors(model)
    qfrc = torch.zeros_like(qvel)
    qfrc[:, dadr] = -model.jnt_stiffness[jids] * (qpos[:, qadr] - model.qpos_spring[qadr])
    return qfrc


def joint_limit_forces(model, qpos, Mdiag, solref=(0.02, 1.0)):
    """Compliant joint limits as a mass-scaled spring-damper (MuJoCo
    solref/solimp semantics, d=0.9, dmax=0.95). Returns (qfrc, extra
    damping); the damping must be integrated implicitly."""
    qadr, dadr, jids = scalar_joint_tensors(model)
    timeconst, dampratio = solref
    q = qpos[:, qadr]
    d_lo = model.jnt_range[jids, 0] - q
    d_hi = q - model.jnt_range[jids, 1]
    m_eff = Mdiag[:, dadr]
    d_imp, dmax = 0.9, 0.95
    k = d_imp / (dmax * dmax * timeconst * timeconst * dampratio * dampratio) * m_eff
    b = 2.0 / (dmax * timeconst) * m_eff
    f = k * (torch.clamp_min(d_lo, 0.0) - torch.clamp_min(d_hi, 0.0))
    active = ((d_lo > 0) | (d_hi > 0)).to(q.dtype)
    limited = model.jnt_limited[jids]
    qfrc = torch.zeros_like(Mdiag)
    damp = torch.zeros_like(Mdiag)
    qfrc[:, dadr] = limited * f
    damp[:, dadr] = limited * active * b
    return qfrc, damp


def tendon_forces(model, qpos, qvel, Mdiag, solref=(0.02, 1.0)):
    """Fixed-tendon passive forces (MuJoCo tendon stiffness, frictionloss
    and range limits): a spring, smooth dry friction and the limits as the
    mass-scaled spring-damper of joint_limit_forces, the tendon's inertia
    taken as (ten_J^2) @ diag(M). Returns (qfrc, extra damping): the limit
    damping and the tendon damping, diagonalised onto the dofs
    (J^T b J ~ diag(b J_i^2)), are integrated implicitly by the engine."""
    L = qpos @ model.ten_Jq.T                                         # (B, ntendon)
    V = qvel @ model.ten_J.T
    f = -model.ten_stiffness * (L - model.ten_springlength)
    f = f - model.ten_frictionloss * torch.tanh(V / 0.005)
    timeconst, dampratio = solref
    J2 = model.ten_J ** 2
    m_eff = Mdiag @ J2.T
    d_imp, dmax = 0.9, 0.95
    k_lim = d_imp / (dmax * dmax * timeconst * timeconst * dampratio * dampratio) * m_eff
    b_lim = 2.0 / (dmax * timeconst) * m_eff
    d_lo = model.ten_range[:, 0] - L
    d_hi = L - model.ten_range[:, 1]
    limited = model.derived("tendon_limited", lambda: torch.tensor(
        model.tendon_limited, dtype=model.qpos0.dtype, device=model.device))
    active = ((d_lo > 0) | (d_hi > 0)).to(L.dtype) * limited
    f = f + limited * k_lim * (torch.clamp_min(d_lo, 0.0) - torch.clamp_min(d_hi, 0.0))
    return f @ model.ten_J, (active * b_lim + model.ten_damping) @ J2
