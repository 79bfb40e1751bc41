"""The packed static model the CUDA kernels read (csrc/common.cuh RsTables).

`RsTables` mirrors the C struct field for field with ctypes (every field
is 4 bytes wide, so neither side pads); the kernel library reports
sizeof(RsTables) and the loader checks the two agree. A model is checked
against the compile-time maxima here, before anything is packed, and
packed once per env into a device byte tensor that every launch gets by
pointer (and a host copy, from which the launchers size shared memory).

`substep_smem_bytes` mirrors the fused substep's shared-memory carve
(csrc/substep.cuh carve_substep): the bytes one scenario takes, computed
from the model's own sizes.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from robosuite_tpu_torch.models import spec as S

MAXB, MAXJ, MAXQ, MAXV, MAXG, MAXS, MAXU, MAXP, MAXK, MAXA, MAXGR = 32, 16, 24, 24, 96, 16, 16, 32, 96, 8, 4
MAXCT = 25 * MAXP  # narrowphase candidates, all pairs

_i, _f, _u = ctypes.c_int32, ctypes.c_float, ctypes.c_uint32


def _a(t, *dims):
    for d in reversed(dims):
        t = t * d
    return t


class RsTables(ctypes.Structure):
    _fields_ = [
        *[(n, _i) for n in ("nq", "nv", "nbody", "njnt", "ngeom", "nsite", "nu", "npair", "nrows",
                            "solver_iters", "power_iters")],
        ("dt", _f), ("impratio", _f),
        ("body_parent", _a(_i, MAXB)), ("body_jntadr", _a(_i, MAXB)), ("body_jntnum", _a(_i, MAXB)),
        ("body_desc", _a(_u, MAXB)),
        ("body_pos", _a(_f, MAXB, 3)), ("body_quat", _a(_f, MAXB, 4)), ("body_ipos", _a(_f, MAXB, 3)),
        ("body_iquat", _a(_f, MAXB, 4)),
        ("jnt_type", _a(_i, MAXJ)), ("jnt_qposadr", _a(_i, MAXJ)), ("jnt_dofadr", _a(_i, MAXJ)),
        ("jnt_pos", _a(_f, MAXJ, 3)), ("jnt_axis", _a(_f, MAXJ, 3)), ("jnt_range", _a(_f, MAXJ, 2)),
        ("jnt_limited", _a(_f, MAXJ)), ("jnt_stiffness", _a(_f, MAXJ)),
        ("qpos0", _a(_f, MAXQ)), ("qpos_spring", _a(_f, MAXQ)),
        ("dof_bodyid", _a(_i, MAXV)), ("dof_free_trans", _a(_i, MAXV)),
        ("dof_damping", _a(_f, MAXV)), ("dof_frictionloss", _a(_f, MAXV)),
        ("anc", _a(_f, MAXB, MAXV)),
        ("geom_bodyid", _a(_i, MAXG)),
        ("geom_pos", _a(_f, MAXG, 3)), ("geom_quat", _a(_f, MAXG, 4)), ("geom_size", _a(_f, MAXG, 3)),
        ("site_bodyid", _a(_i, MAXS)), ("site_pos", _a(_f, MAXS, 3)), ("site_quat", _a(_f, MAXS, 4)),
        ("act_kind", _a(_i, MAXU)), ("act_dofadr", _a(_i, MAXU)), ("act_qposadr", _a(_i, MAXU)),
        ("act_gear", _a(_f, MAXU)), ("act_gain", _a(_f, MAXU)), ("act_ctrllimited", _a(_f, MAXU)),
        ("act_ctrlrange", _a(_f, MAXU, 2)), ("act_forcelimited", _a(_f, MAXU)),
        ("act_forcerange", _a(_f, MAXU, 2)),
        ("pair_kind", _a(_i, MAXP)), ("pair_g1", _a(_i, MAXP)), ("pair_g2", _a(_i, MAXP)),
        ("pair_flip", _a(_i, MAXP)), ("pair_npts", _a(_i, MAXP)), ("pair_row", _a(_i, MAXP)),
        ("pair_body1", _a(_i, MAXP)), ("pair_body2", _a(_i, MAXP)),
        ("pair_friction", _a(_f, MAXP)), ("pair_solref", _a(_f, MAXP, 2)), ("pair_solimp", _a(_f, MAXP, 5)),
        ("pair_margin", _a(_f, MAXP)), ("row_pair", _a(_i, MAXK)), ("pair_k", _a(_i, MAXP)),
        ("pair_cand", _a(_i, MAXP + 1)), ("ncand", _i), ("cand_pi", _a(_i, MAXCT)),
        *[(n, _i) for n in ("na", "eef_site", "center_site", "uncouple", "ngrip")],
        *[(n, _i) for n in ("ctrl_type", "torque_comp", "raw_pd", "goal_stride", "gains_stride")],
        ("arm_qv", _a(_i, MAXA)), ("arm_qp", _a(_i, MAXA)), ("arm_act", _a(_i, MAXA)),
        ("torque_lo", _a(_f, MAXA)), ("torque_hi", _a(_f, MAXA)), ("initial_joint", _a(_f, MAXA)),
        ("grip_act", _a(_i, MAXGR)),
    ]


_PAIR_KIND = {(S.PLANE, S.BOX): 0, (S.CYLINDER, S.BOX): 1, (S.BOX, S.BOX): 2}
_NCAND = {0: 8, 1: 2, 2: 25}  # narrowphase candidates per pair kind (csrc/narrowphase.cuh pair_ncand)
_ACT_KIND = {"motor": 0, "position": 1, "velocity": 2}
_CTRL_TYPE = {"osc": 0, "joint_pos": 1}


def _set(field, values):
    """Copy a (nested) numpy array into a ctypes array field."""
    flat = np.asarray(values).reshape(-1)
    np.ctypeslib.as_array(field).reshape(-1)[: flat.size] = flat


def check_model(model):
    """Raise when the model exceeds the kernels' compile-time maxima."""
    from robosuite_tpu_torch.physics import contact as C

    limits = dict(nbody=MAXB, njnt=MAXJ, nq=MAXQ, nv=MAXV, ngeom=MAXG, nsite=MAXS, nu=MAXU, npair=MAXP)
    for name, cap in limits.items():
        if getattr(model, name) > cap:
            raise ValueError(f"{name}={getattr(model, name)} exceeds the kernels' maximum {cap}")
    nrows = sum(len(r) for r in C.contact_row_layout(model).values())
    if nrows > MAXK:
        raise ValueError(f"{nrows} contact rows exceed the kernels' maximum {MAXK}")
    for a, kind in enumerate(model.actuator_kind):
        if kind not in _ACT_KIND:
            raise NotImplementedError(f"actuator kind {kind!r} is not ported")
    return nrows


def pack(model, arm=None, device=None) -> torch.Tensor:
    """The model (and, for the fused substep, the arm's static controller
    data `arm`, a dict) as a uint8 tensor holding one RsTables."""
    raw = bytes(fill(model, arm))
    return torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(device or model.device)


def fill(model, arm=None) -> RsTables:
    """The RsTables of `model` (and `arm`, see pack)."""
    from robosuite_tpu_torch.physics import contact as C
    from robosuite_tpu_torch.physics import dynamics as D

    nrows = check_model(model)
    t = RsTables()
    cpu = {name: buf.detach().cpu().numpy() for name, buf in model.named_buffers()}
    for n in ("nq", "nv", "nbody", "njnt", "ngeom", "nsite", "nu", "npair"):
        setattr(t, n, getattr(model, n))
    t.nrows = nrows
    t.solver_iters, t.power_iters = C.solver_iterations(model)
    t.dt, t.impratio = model.timestep, model.impratio

    _set(t.body_parent, model.body_parentid)
    _set(t.body_jntadr, model.body_jntadr)
    _set(t.body_jntnum, model.body_jntnum)
    anc_b = D.body_ancestor_matrix(model)
    _set(t.body_desc, [sum(1 << j for j in range(model.nbody) if anc_b[i, j]) for i in range(model.nbody)])
    for n in ("body_pos", "body_quat", "body_ipos", "body_iquat"):
        _set(getattr(t, n), cpu[n])
    _set(t.jnt_type, model.jnt_type)
    _set(t.jnt_qposadr, model.jnt_qposadr)
    _set(t.jnt_dofadr, model.jnt_dofadr)
    for n in ("jnt_pos", "jnt_axis", "jnt_range", "jnt_limited", "jnt_stiffness", "qpos0", "qpos_spring",
              "dof_damping", "dof_frictionloss", "geom_pos", "geom_quat", "geom_size", "site_pos", "site_quat"):
        _set(getattr(t, n), cpu[n])
    _set(t.dof_bodyid, model.dof_bodyid)
    free_trans = np.zeros(model.nv, dtype=np.int32)
    for j in range(model.njnt):
        if model.jnt_type[j] == S.FREE:
            free_trans[model.jnt_dofadr[j]:model.jnt_dofadr[j] + 3] = 1
    _set(t.dof_free_trans, free_trans)
    anc = np.zeros((MAXB, MAXV), dtype=np.float32)
    anc[: model.nbody, : model.nv] = cpu["ancestor_mask"]
    _set(t.anc, anc)
    _set(t.geom_bodyid, model.geom_bodyid)
    _set(t.site_bodyid, model.site_bodyid)

    _set(t.act_kind, [_ACT_KIND[k] for k in model.actuator_kind])
    _set(t.act_dofadr, [model.jnt_dofadr[j] for j in model.actuator_jntid])
    _set(t.act_qposadr, [model.jnt_qposadr[j] for j in model.actuator_jntid])
    _set(t.act_gear, cpu["actuator_gear"])
    _set(t.act_gain, cpu["actuator_gainprm"])
    _set(t.act_ctrllimited, cpu["actuator_ctrllimited"])
    _set(t.act_ctrlrange, cpu["actuator_ctrlrange"])
    _set(t.act_forcelimited, cpu["actuator_forcelimited"])
    _set(t.act_forcerange, cpu["actuator_forcerange"])

    layout = C.contact_row_layout(model)
    i = 0
    t.pair_cand[0] = 0
    row_pair = np.zeros(MAXK, dtype=np.int32)
    for key, items in sorted(C.pair_groups(model).items()):
        for g1, g2, k, flip in items:
            rows = layout[k]
            t.pair_kind[i] = _PAIR_KIND[key]
            t.pair_g1[i], t.pair_g2[i], t.pair_flip[i] = g1, g2, int(flip)
            t.pair_npts[i], t.pair_row[i] = len(rows), rows[0]
            t.pair_body1[i] = model.geom_bodyid[model.pair_geom1[k]]
            t.pair_body2[i] = model.geom_bodyid[model.pair_geom2[k]]
            t.pair_friction[i] = cpu["pair_friction"][k, 0]
            _set(t.pair_solref[i], cpu["pair_solref"][k])
            _set(t.pair_solimp[i], cpu["pair_solimp"][k])
            t.pair_margin[i] = cpu["pair_margin"][k]
            t.pair_k[i] = k
            t.pair_cand[i + 1] = t.pair_cand[i] + _NCAND[t.pair_kind[i]]
            row_pair[rows] = i
            i += 1
    t.ncand = t.pair_cand[i]
    # the candidates grouped by the code path that computes them (stable, so
    # pair order within a path), so a warp's lanes mostly take one path
    path = lambda kind, k: kind if kind != 2 else 2 + (k >= 16)  # noqa: E731
    order = sorted(((p, k) for p in range(i) for k in range(_NCAND[t.pair_kind[p]])),
                   key=lambda pk: path(t.pair_kind[pk[0]], pk[1]))
    _set(t.cand_pi, np.array([32 * p + k for p, k in order] + [0] * (MAXCT - len(order)), dtype=np.int32))
    _set(t.row_pair, row_pair)

    if arm is not None:
        na = len(arm["qv_idx"])
        if na > MAXA or len(arm["grip_actuators"]) > MAXGR:
            raise ValueError("arm or gripper exceeds the kernels' maxima")
        t.na, t.ngrip = na, len(arm["grip_actuators"])
        t.eef_site, t.center_site, t.uncouple = arm["eef_site"], arm["center_site"], int(arm["uncouple"])
        t.ctrl_type = _CTRL_TYPE[arm["ctrl_type"]]
        t.torque_comp, t.raw_pd = int(arm["use_torque_compensation"]), int(arm["raw_pd"])
        t.goal_stride, t.gains_stride = arm["goal_width"], arm["gains_width"]
        for n in ("arm_qv", "arm_qp", "arm_act", "torque_lo", "torque_hi", "initial_joint", "grip_act"):
            src = {"arm_qv": "qv_idx", "arm_qp": "qp_idx", "arm_act": "actuator_ids",
                   "grip_act": "grip_actuators"}.get(n, n)
            _set(getattr(t, n), arm[src])
    return t


OSC_WORDS = 952 * 2  # sizeof(OscScratch) / 4 (csrc/osc.cuh): 952 doubles
PF_WORDS = 25        # a pair frame (csrc/narrowphase.cuh RS_PF)


class _Carver:
    """Counts words as csrc/common.cuh Carver takes them."""

    def __init__(self, w=0):
        self.w = w

    def take(self, words, align=1):
        self.w = -(-self.w // align) * align + words

    def take_d(self, n):
        self.take(2 * n, 2)


def substep_smem_bytes(t: RsTables) -> int:
    """Shared memory of one fused-substep scenario, in bytes, for the packed
    table t: csrc/substep.cuh carve_substep, region for region."""
    nq, nv, nb, K = t.nq, t.nv, t.nbody, t.nrows
    c = _Carver()
    for words in (nq, nv, nv, nb, 3 * nb, 4, 3 * nb, 4 * nb, 9 * nb, 3 * nb, 9 * nb, 3 * nv, 3 * nv, nv * nv, nv,
                  t.nu, MAXA, nq, nv, PF_WORDS * t.npair, K, K):
        c.take(words)
    for words in (3 * K,) * 5 + (K, K, nv, nv, nv, K):  # carve_solve (rhs on aref, v on y), the active rows
        c.take(words)
    for n in (nv * (nv | 1), nv, nv, nv):
        c.take_d(n)
    u0 = -(-c.w // 2) * 2
    union = (15 * nv + 12 * nb, nv * ((3 * K) | 1), t.ncand, OSC_WORDS if t.ctrl_type == _CTRL_TYPE["osc"] else 0)
    w = u0 + max(union)
    return 4 * (-(-w // 4) * 4)
