"""Forward kinematics and Jacobians on batched tensors (the JAX package's
physics/kinematics.py; MuJoCo mj_kinematics / mj_jacSite).

Conventions (as in the JAX package): free-joint qpos is the world pose;
free/ball angular qvel is body-local; rotation is about the body-frame
origin; the per-dof motion subspace sdof is origin-referenced.
"""

from __future__ import annotations

import torch

from robosuite_tpu_torch.models import spec as S
from robosuite_tpu_torch.physics.state import KinData
from robosuite_tpu_torch.utils import transforms as T


def fk(model, qpos) -> KinData:
    """Body/geom/site poses + per-dof motion subspace for qpos (B, nq)."""
    B = qpos.shape[0]
    xpos, xquat, sdof_ang, sdof_lin = _tree(model, qpos, subspace=True)
    xmat = T.quat2mat_wxyz(xquat)
    xipos = xpos + torch.einsum("bnij,nj->bni", xmat, model.body_ipos)
    ximat = T.quat2mat_wxyz(T.quat_mul_wxyz(xquat, model.body_iquat.expand(xquat.shape)))

    geom_xpos, geom_xmat = geom_poses(model, xpos, xquat, xmat)
    sb = list(model.site_bodyid)
    site_xpos = xpos[:, sb] + torch.einsum("bsij,sj->bsi", xmat[:, sb], model.site_pos)
    site_xmat = T.quat2mat_wxyz(T.quat_mul_wxyz(xquat[:, sb], model.site_quat.expand(B, -1, 4)))

    return KinData(
        xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos, ximat=ximat, sdof_ang=sdof_ang, sdof_lin=sdof_lin,
        geom_xpos=geom_xpos, geom_xmat=geom_xmat, site_xpos=site_xpos, site_xmat=site_xmat,
    )


def body_poses(model, qpos):
    """(xpos (B, nbody, 3), xquat (B, nbody, 4)): the pose-only FK (the
    plain version of the K4 kernel). Free of in-place writes, so
    torch.func transforms (the MPC's residual Jacobians) go through it."""
    xpos, xquat, _, _ = _tree(model, qpos, subspace=False)
    return xpos, xquat


def geom_poses(model, xpos, xquat, xmat=None):
    """(geom_xpos (B, ngeom, 3), geom_xmat (B, ngeom, 3, 3)) from the body
    poses (xmat, the bodies' rotations, is made from xquat if not given)."""
    gb = list(model.geom_bodyid)
    xmat = T.quat2mat_wxyz(xquat[:, gb]) if xmat is None else xmat[:, gb]
    return (xpos[:, gb] + torch.einsum("bgij,gj->bgi", xmat, model.geom_pos),
            T.quat2mat_wxyz(T.quat_mul_wxyz(xquat[:, gb], model.geom_quat.expand(xpos.shape[0], -1, 4))))


def site_pos(model, xpos, xquat, siteid: int):
    """(B, 3) world position of a site from its body's pose."""
    b = model.site_bodyid[siteid]
    return xpos[:, b] + T.quat_rot_wxyz(xquat[:, b], model.site_pos[siteid])


def _tree(model, qpos, subspace):
    """The tree walk: body poses and, with `subspace`, the per-dof motion
    subspace (else None)."""
    B = qpos.shape[0]
    dtype, dev = qpos.dtype, qpos.device
    nb = model.nbody
    xpos = [None] * nb
    xquat = [None] * nb
    xpos[0] = torch.zeros(B, 3, dtype=dtype, device=dev)
    xquat[0] = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=dev).expand(B, 4)
    sdof_ang = [None] * model.nv
    sdof_lin = [None] * model.nv
    zero3 = torch.zeros(B, 3, dtype=dtype, device=dev)
    eye = torch.eye(3, dtype=dtype, device=dev)

    for b in range(1, nb):
        p = model.body_parentid[b]
        pos = xpos[p] + T.quat_rot_wxyz(xquat[p], model.body_pos[b])
        quat = T.quat_mul_wxyz(xquat[p], model.body_quat[b].expand(B, 4))
        jadr, jnum = model.body_jntadr[b], model.body_jntnum[b]
        for j in range(jadr, jadr + jnum):
            jt = model.jnt_type[j]
            qadr = model.jnt_qposadr[j]
            dadr = model.jnt_dofadr[j]
            if jt == S.FREE:
                pos = qpos[:, qadr:qadr + 3]
                quat = T.unit_vector(qpos[:, qadr + 3:qadr + 7])
                R = T.quat2mat_wxyz(quat)
                for i in range(3):  # translation dofs, world axes
                    sdof_ang[dadr + i] = zero3
                    sdof_lin[dadr + i] = eye[i].expand(B, 3)
                for i in range(3):  # rotation dofs: body-local axes about the body origin
                    a = R[:, :, i]
                    sdof_ang[dadr + 3 + i] = a
                    sdof_lin[dadr + 3 + i] = torch.linalg.cross(pos, a)
            elif jt == S.BALL:
                anchor = pos + T.quat_rot_wxyz(quat, model.jnt_pos[j])
                quat = T.quat_mul_wxyz(quat, T.unit_vector(qpos[:, qadr:qadr + 4]))
                pos = anchor - T.quat_rot_wxyz(quat, model.jnt_pos[j])
                R = T.quat2mat_wxyz(quat)
                for i in range(3):
                    a = R[:, :, i]
                    sdof_ang[dadr + i] = a
                    sdof_lin[dadr + i] = torch.linalg.cross(anchor, a)
            elif jt == S.SLIDE:
                axis_w = T.quat_rot_wxyz(quat, model.jnt_axis[j])
                pos = pos + axis_w * (qpos[:, qadr:qadr + 1] - model.qpos0[qadr])
                sdof_ang[dadr] = zero3
                sdof_lin[dadr] = axis_w
            else:  # HINGE
                axis_w = T.quat_rot_wxyz(quat, model.jnt_axis[j])
                anchor = pos + T.quat_rot_wxyz(quat, model.jnt_pos[j])
                half = 0.5 * (qpos[:, qadr:qadr + 1] - model.qpos0[qadr])
                q_loc = torch.cat([torch.cos(half), torch.sin(half) * model.jnt_axis[j]], dim=-1)
                quat = T.quat_mul_wxyz(quat, q_loc)
                pos = anchor - T.quat_rot_wxyz(quat, model.jnt_pos[j])
                sdof_ang[dadr] = axis_w
                sdof_lin[dadr] = torch.linalg.cross(anchor, axis_w)
        xpos[b], xquat[b] = pos, quat

    if not subspace:
        return torch.stack(xpos, dim=1), torch.stack(xquat, dim=1), None, None
    return (torch.stack(xpos, dim=1), torch.stack(xquat, dim=1),
            torch.stack(sdof_ang, dim=1), torch.stack(sdof_lin, dim=1))


def body_velocities(model, kin: KinData, qvel):
    """(angular, linear) spatial velocity of every body, world frame,
    origin-referenced, each (B, nbody, 3): each body's sum over the dofs
    that move it of S_d qvel_d."""
    anc = model.ancestor_mask
    return anc @ (kin.sdof_ang * qvel[..., None]), anc @ (kin.sdof_lin * qvel[..., None])


def point_jacobian(model, kin: KinData, bodyid: int, point):
    """(jacp (B, 3, nv), jacr (B, 3, nv)) of a world point attached to
    body `bodyid` (MuJoCo mj_jac). point: (B, 3)."""
    mask = model.ancestor_mask[bodyid][:, None]  # (nv, 1)
    jacr = (kin.sdof_ang * mask).transpose(1, 2)
    lin = kin.sdof_lin + torch.linalg.cross(kin.sdof_ang, point[:, None, :].expand_as(kin.sdof_ang))
    jacp = (lin * mask).transpose(1, 2)
    return jacp, jacr


def site_jacobian(model, kin: KinData, siteid: int):
    """mj_jacSite."""
    return point_jacobian(model, kin, model.site_bodyid[siteid], kin.site_xpos[:, siteid])


def site_velocity(model, kin: KinData, qvel, siteid: int):
    """(linear, angular) world-frame velocity of a site, each (B, 3)."""
    jacp, jacr = site_jacobian(model, kin, siteid)
    return (jacp @ qvel[:, :, None])[..., 0], (jacr @ qvel[:, :, None])[..., 0]
