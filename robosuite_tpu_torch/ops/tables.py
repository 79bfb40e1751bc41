"""The packed static model the CUDA kernels read (csrc/common.cuh RsTables).

`RsTables` mirrors the C struct field for field with ctypes (every field
is 4 bytes wide, so neither side pads); the kernel library reports
sizeof(RsTables) and the loader checks the two agree. A model is checked
against the compile-time maxima here, before anything is packed, and
packed once per env into a device byte tensor that every launch gets by
pointer (and a host copy, from which the launchers size shared memory).

The contact part (pairs, rows, candidates) is packed only for the fused
substep (K3): forward products (K1) and pose-only FK (K4) read the tree,
the geoms and the sites, so a world with more pairs or rows than K3 takes
(PickPlace: 606 pairs) still fits them.

The table also lists the (body, dof) pairs that CRBA and RNEA run over
(`pair_lists`), in the fixed orders their sums take, and where each mass
matrix entry comes from (`mass_matrix_sources`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from robosuite_tpu_torch.models import spec as S

MAXB, MAXJ, MAXQ, MAXV, MAXG, MAXS, MAXU, MAXP, MAXK, MAXA, MAXGR = 96, 56, 64, 60, 176, 52, 24, 64, 192, 8, 12
MAXE = 8  # equality rows of K2
MAXPR = 896  # (body, dof) pairs with anc != 0
MAXCT = 25 * MAXP  # narrowphase candidates, all pairs

_i, _f = ctypes.c_int32, ctypes.c_float


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
        ("body_pos", _a(_f, MAXB, 3)), ("body_quat", _a(_f, MAXB, 4)), ("body_ipos", _a(_f, MAXB, 3)),
        ("body_iquat", _a(_f, MAXB, 4)),
        ("jnt_type", _a(_i, MAXJ)), ("jnt_qposadr", _a(_i, MAXJ)), ("jnt_dofadr", _a(_i, MAXJ)),
        ("jnt_pos", _a(_f, MAXJ, 3)), ("jnt_axis", _a(_f, MAXJ, 3)), ("jnt_range", _a(_f, MAXJ, 2)),
        ("jnt_limited", _a(_f, MAXJ)), ("jnt_stiffness", _a(_f, MAXJ)),
        ("qpos0", _a(_f, MAXQ)), ("qpos_spring", _a(_f, MAXQ)),
        ("dof_bodyid", _a(_i, MAXV)), ("dof_free_trans", _a(_i, MAXV)),
        ("dof_damping", _a(_f, MAXV)), ("dof_frictionloss", _a(_f, MAXV)),
        ("anc", _a(_f, MAXB, MAXV)),
        ("npr", _i), ("pr_db", _a(_i, MAXPR)), ("dof_pr0", _a(_i, MAXV + 1)), ("pr_bd", _a(_i, MAXPR)),
        ("body_pr0", _a(_i, MAXB + 1)), ("m_rc", _a(_i, MAXV * MAXV)),
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


PAIR_KIND = {(S.PLANE, S.BOX): 0, (S.CYLINDER, S.BOX): 1, (S.BOX, S.BOX): 2, (S.PLANE, S.CYLINDER): 3,
             (S.CYLINDER, S.CYLINDER): 4}
_NCAND = {0: 8, 1: 2, 2: 25, 3: 3, 4: 1}  # narrowphase candidates per pair kind (csrc/narrowphase.cuh pair_ncand)


def _path(kind, k):
    """The code path of candidate k of a pair of `kind` in
    csrc/narrowphase.cuh candidate(): box-box's vertex tests (k < 16) and
    edge crosses apart."""
    return {0: 0, 1: 1, 2: 2 + (k >= 16), 3: 4, 4: 5}[kind]
_ACT_KIND = {"motor": 0, "position": 1, "velocity": 2}
_CTRL_TYPE = {"osc": 0, "joint_pos": 1}


def _set(field, values):
    """Copy a (nested) numpy array into a ctypes array field."""
    flat = np.asarray(values).reshape(-1)
    np.ctypeslib.as_array(field).reshape(-1)[: flat.size] = flat


def check_model(model, contacts=True):
    """Raise when the model exceeds the kernels' compile-time maxima; where
    `contacts` (the fused substep, K3), also when its contacts (pairs,
    rows, pair kinds) do or it has an actuator kind or a tendon
    transmission K3 does not take (its gate, ops/substep.extract_spec,
    refuses tendons and equalities first), or more actuators than it
    packs; -> its contact rows (0 without). K1 and K4 read no actuator, so
    without `contacts` any kind and any number passes."""
    from robosuite_tpu_torch.physics import contact as C

    limits = dict(nbody=MAXB, njnt=MAXJ, nq=MAXQ, nv=MAXV, ngeom=MAXG, nsite=MAXS)
    if contacts:
        limits.update(nu=MAXU, npair=MAXP)
    for name, cap in limits.items():
        if getattr(model, name) > cap:
            raise ValueError(f"{name}={getattr(model, name)} exceeds the kernels' maximum {cap}")
    npr = int(model.ancestor_mask.count_nonzero())
    if npr > MAXPR:
        raise ValueError(f"{npr} (body, dof) pairs exceed the kernels' maximum {MAXPR}")
    if not contacts:
        return 0
    for a, kind in enumerate(model.actuator_kind):
        if kind not in _ACT_KIND or model.actuator_jntid[a] < 0:
            raise NotImplementedError(f"actuator {model.actuator_names[a]} ({kind!r}"
                                      f"{', on a tendon' if model.actuator_jntid[a] < 0 else ''}) has no fused law")
    nrows = sum(len(r) for r in C.contact_row_layout(model).values())
    if nrows > MAXK:
        raise ValueError(f"{nrows} contact rows exceed the kernels' maximum {MAXK}")
    for key in C.pair_groups(model):
        if key not in PAIR_KIND:
            raise NotImplementedError(f"pair type {key} has no CUDA narrowphase")
    return nrows


def pair_lists(anc):
    """The (body, dof) pairs of the 0/1 matrix anc (nbody, nv) with anc != 0,
    as RsTables packs them: (dof-major entries 256 b + d, each dof's first
    index (nv + 1), body-major entries d, each body's first index (nbody +
    1)). CRBA and RNEA (f) sum each dof's run in body order, RNEA (c) and
    (e) each body's run in dof order: the orders of a plain loop."""
    anc = np.asarray(anc) != 0
    nb, nv = anc.shape
    db = [256 * b + d for d in range(nv) for b in range(nb) if anc[b, d]]
    bd = [d for b in range(nb) for d in range(nv) if anc[b, d]]
    dof0 = np.concatenate([[0], np.cumsum(anc.sum(0))]).astype(np.int32)
    body0 = np.concatenate([[0], np.cumsum(anc.sum(1))]).astype(np.int32)
    return np.array(db, dtype=np.int32), dof0, np.array(bd, dtype=np.int32), body0


def mass_matrix_sources(anc, dof_bodyid):
    """Each M entry's source (e nv + d): 256 row + col where dof `row` moves
    body(col) (e moves body(d): (e, d); else d moves body(e): (d, e)), -1
    where neither does (the entry is 0 but for armature)."""
    anc = np.asarray(anc) != 0
    nv = anc.shape[1]
    out = np.full(nv * nv, -1, dtype=np.int32)
    for e in range(nv):
        for d in range(nv):
            if anc[dof_bodyid[d], e]:
                out[e * nv + d] = 256 * e + d
            elif anc[dof_bodyid[e], d]:
                out[e * nv + d] = 256 * d + e
    return out


def pack(model, arm=None, device=None) -> torch.Tensor:
    """The model as a uint8 tensor holding one RsTables: for the fused
    substep, with `arm` (the arm's static controller data, a dict), also
    its contact part; without (K1, K4), none, so that they take a world
    whatever its pairs."""
    raw = bytes(fill(model, arm))
    return torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(device or model.device)


def fill(model, arm=None) -> RsTables:
    """The RsTables of `model` (and `arm`: see pack)."""
    from robosuite_tpu_torch.physics import contact as C

    contacts = arm is not None
    nrows = check_model(model, contacts)
    t = RsTables()
    cpu = {name: buf.detach().cpu().numpy() for name, buf in model.named_buffers()}
    for n in ("nq", "nv", "nbody", "njnt", "ngeom", "nsite", "nu"):
        setattr(t, n, getattr(model, n))
    t.npair = model.npair if contacts else 0
    t.nrows = nrows
    t.solver_iters, t.power_iters = C.solver_iterations(model)
    t.dt, t.impratio = model.timestep, model.impratio

    _set(t.body_parent, model.body_parentid)
    _set(t.body_jntadr, model.body_jntadr)
    _set(t.body_jntnum, model.body_jntnum)
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
    pr_db, dof0, pr_bd, body0 = pair_lists(cpu["ancestor_mask"])
    t.npr = len(pr_db)
    for name, v in (("pr_db", pr_db), ("dof_pr0", dof0), ("pr_bd", pr_bd), ("body_pr0", body0)):
        _set(getattr(t, name), v)
    _set(t.m_rc, mass_matrix_sources(cpu["ancestor_mask"], model.dof_bodyid))
    _set(t.geom_bodyid, model.geom_bodyid)
    _set(t.site_bodyid, model.site_bodyid)

    if contacts:  # the actuators (read by K3 only) and the contact part
        _set(t.act_kind, [_ACT_KIND[k] for k in model.actuator_kind])
        _set(t.act_dofadr, [model.jnt_dofadr[j] for j in model.actuator_jntid])
        _set(t.act_qposadr, [model.jnt_qposadr[j] for j in model.actuator_jntid])
        _set(t.act_gear, cpu["actuator_gear"])
        _set(t.act_gain, cpu["actuator_gainprm"])
        _set(t.act_ctrllimited, cpu["actuator_ctrllimited"])
        _set(t.act_ctrlrange, cpu["actuator_ctrlrange"])
        _set(t.act_forcelimited, cpu["actuator_forcelimited"])
        _set(t.act_forcerange, cpu["actuator_forcerange"])
        _fill_contacts(t, model, cpu)

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


def _fill_contacts(t, model, cpu):
    """The contact part of t: the pairs in the buffer's group-major order,
    their rows and the narrowphase candidates."""
    from robosuite_tpu_torch.physics import contact as C

    layout = C.contact_row_layout(model)
    i = 0
    t.pair_cand[0] = 0
    row_pair = np.zeros(MAXK, dtype=np.int32)
    for key, items in sorted(C.pair_groups(model).items()):
        for g1, g2, k, flip in items:
            rows = layout[k]
            t.pair_kind[i] = PAIR_KIND[key]
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
    order = sorted(((p, k) for p in range(i) for k in range(_NCAND[t.pair_kind[p]])),
                   key=lambda pk: _path(t.pair_kind[pk[0]], pk[1]))
    _set(t.cand_pi, np.array([32 * p + k for p, k in order] + [0] * (MAXCT - len(order)), dtype=np.int32))
    _set(t.row_pair, row_pair)
