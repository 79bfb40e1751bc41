"""Equality constraints: bilateral rows for the constraint solver, on
batched tensors (the JAX package's physics/equality.py; MuJoCo's connect,
weld, joint and tendon equalities).

Each equality contributes Jacobian rows and a solref reference
acceleration. The rows follow the contact rows in the solver's layout
[normals | t1 | t2 | equality] and are solved with them, never projected
(physics/contact.solver_inputs, ops/contact_solve.py). XArm7's gripper
closes its four-bar fingers with connect and joint rows; the Robotiq and
Jaco grippers pin their finger-coupling tendons' lengths with tendon rows.
"""

from __future__ import annotations

import torch

from robosuite_tpu_torch.physics import kinematics
from robosuite_tpu_torch.utils import transforms as T


def equality_row_count(model) -> int:
    """The static number of bilateral rows (3 a connect, 6 a weld, 1 a
    joint or tendon coupling)."""
    return sum({"connect": 3, "weld": 6}.get(kind, 1) for kind in model.eq_kind)


def _poly(coef, d):
    return coef[0] + d * (coef[1] + d * (coef[2] + d * (coef[3] + d * coef[4])))


def _dpoly(coef, d):
    return coef[1] + d * (2 * coef[2] + d * (3 * coef[3] + d * 4 * coef[4]))


def equality_rows(model, kin, qpos, qvel):
    """-> (J_eq (B, ne, nv), aref_eq (B, ne)), or None for a world with no
    equality. aref = -b (J qvel) - k err, with MuJoCo's solref law:
    k = 1 / (timeconst^2 dampratio^2), b = 2 / timeconst, timeconst at
    least two substeps."""
    if model.neq == 0:
        return None
    B, nv = qvel.shape
    J_rows, aref_rows = [], []
    solref, polycoef = model.eq_solref, model.eq_polycoef
    for i, kind in enumerate(model.eq_kind):
        timeconst = torch.clamp_min(solref[i, 0], 2.0 * model.timestep)
        dampratio = torch.clamp_min(solref[i, 1], 1e-3)
        k = 1.0 / (timeconst * timeconst * dampratio * dampratio)
        b = 2.0 / timeconst
        o1, o2 = model.eq_obj1[i], model.eq_obj2[i]
        if kind in ("connect", "weld"):
            p1 = kin.xpos[:, o1] + (kin.xmat[:, o1] @ model.eq_anchor[i])
            p2 = kin.xpos[:, o2] + (kin.xmat[:, o2] @ model.eq_anchor2[i])
            jacp1, jacr1 = kinematics.point_jacobian(model, kin, o1, p1)
            jacp2, jacr2 = kinematics.point_jacobian(model, kin, o2, p2)
            Jrel = jacp1 - jacp2                                                  # (B, 3, nv)
            vel = (Jrel @ qvel[:, :, None])[..., 0]
            J_rows.append(Jrel)
            aref_rows.append(-b * vel - k * (p1 - p2))
            if kind == "weld":
                Jang = jacr1 - jacr2
                ang_err = T.orientation_error(kin.xmat[:, o2], kin.xmat[:, o1])
                ang_vel = (Jang @ qvel[:, :, None])[..., 0]
                J_rows.append(Jang)
                aref_rows.append(-b * ang_vel - k * (-ang_err))
            continue
        coef = polycoef[i]
        if kind == "tendon":
            # tendon o1's length coupled to poly(tendon o2's); with no o2, pinned
            # to polycoef[0] (MuJoCo mjEQ_TENDON)
            row = model.ten_J[o1].expand(B, nv)
            L1 = qpos @ model.ten_Jq[o1]
            if o2 >= 0:
                d = qpos @ model.ten_Jq[o2] - model.ten_length0[o2]
                row = row - _dpoly(coef, d)[:, None] * model.ten_J[o2]
                err = (L1 - model.ten_length0[o1]) - _poly(coef, d)
            else:
                err = L1 - coef[0]
        else:  # joint o1 coupled to poly(joint o2)
            d1 = model.jnt_dofadr[o1]
            row = torch.zeros(B, nv, dtype=qvel.dtype, device=qvel.device)
            row[:, d1] = 1.0
            if o2 >= 0:
                q2 = qpos[:, model.jnt_qposadr[o2]]
                row[:, model.jnt_dofadr[o2]] = -_dpoly(coef, q2)
                err = qpos[:, model.jnt_qposadr[o1]] - _poly(coef, q2)
            else:
                err = qpos[:, model.jnt_qposadr[o1]] - coef[0]
        vel = torch.sum(row * qvel, dim=-1)
        J_rows.append(row[:, None, :])
        aref_rows.append((-b * vel - k * err)[:, None])
    return torch.cat(J_rows, dim=1), torch.cat(aref_rows, dim=1)
