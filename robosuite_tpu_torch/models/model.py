"""Model compiler: ModelSpec -> Model (an nn.Module of tensors).

The counterpart of the JAX package's models/model.py compile_spec, trimmed
to what a manipulation world of primitive geoms and convex hulls needs
(a fixed, wheeled or legged robot: planar base joints with velocity
actuators, a free root beside an object's), with its fixed tendons, tendon
and `general` actuators and equality constraints (no cameras or lights). All name resolution happens
here, once: the physics sees integer-indexed tensors.

Array leaves are registered buffers, so `model.to(device)` moves them;
static structure (tree topology, joint types, pair lists, names) are plain
Python attributes.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn

from robosuite_tpu_torch.models import spec as S

# Array leaves of the compiled model, in the JAX Model's field names.
LEAVES = (
    "body_pos", "body_quat", "body_ipos", "body_iquat", "body_mass", "body_inertia",
    "jnt_pos", "jnt_axis", "jnt_range", "jnt_limited", "jnt_stiffness",
    "dof_damping", "dof_armature", "dof_frictionloss",
    "geom_pos", "geom_quat", "geom_size", "geom_friction", "geom_margin",
    "site_pos", "site_quat",
    "actuator_gear", "actuator_ctrlrange", "actuator_forcerange", "actuator_gainprm",
    "actuator_biasprm", "actuator_ctrllimited", "actuator_forcelimited",
    "pair_friction", "pair_solref", "pair_solimp", "pair_margin",
    # convex hulls, padded to the model-wide max V / F (vertex padding
    # repeats vertex 0, face padding is a far plane): vertices (nmesh, V, 3),
    # outward face normals (nmesh, F, 3), plane offsets (nmesh, F), n.x <= d
    "mesh_verts", "mesh_fnorm", "mesh_fdist",
    "qpos0", "qpos_spring", "gravity", "ancestor_mask",
    # fixed tendons: length = ten_Jq @ qpos, moment rows ten_J on the dofs
    "ten_J", "ten_Jq", "ten_range", "ten_stiffness", "ten_springlength", "ten_frictionloss", "ten_damping",
    "ten_length0",
    # equality constraints: connect anchors (body1 frame, and body2 frame at
    # qpos0), joint / tendon polynomials, solref
    "eq_anchor", "eq_anchor2", "eq_polycoef", "eq_solref",
)

# Static (non-array) fields, in the JAX Model's field names.
STATIC = (
    "nq", "nv", "nu", "nbody", "njnt", "ngeom", "nsite", "npair",
    "body_parentid", "body_jntadr", "body_jntnum", "body_weldid",
    "jnt_type", "jnt_bodyid", "jnt_qposadr", "jnt_dofadr", "dof_bodyid", "dof_jntid",
    "geom_bodyid", "geom_type", "site_bodyid",
    "actuator_kind", "actuator_jntid", "pair_geom1", "pair_geom2",
    "actuator_tenid",  # -1: joint transmission (actuator_jntid -1: tendon)
    "ntendon", "tendon_names", "tendon_limited",
    # eq_obj1/2: bodies (connect, weld), joints (joint) or tendons (tendon); -1 none
    "neq", "eq_kind", "eq_obj1", "eq_obj2",
    "nmesh", "mesh_names", "geom_meshid",  # geom_meshid -1: no hull
    "body_names", "jnt_names", "geom_names", "site_names", "actuator_names",
    "timestep", "impratio",
    # planning-model overrides, None = the execution defaults: contact
    # solver iterations (contact.APGD_ITERS), its power iterations
    # (contact.POWER_ITERS), points per pair (contact.MANIFOLD_CAP)
    "solver_iters", "solver_power_iters", "pair_points_cap",
)


class Model(nn.Module):
    """Compiled model: the constants of one world, shared by every scenario
    of a batch. Build with compile_spec (or convert.model_from_numpy)."""

    def __init__(self, leaves: Dict[str, np.ndarray], meta: dict, dtype=torch.float32):
        super().__init__()
        for name in STATIC:
            v = meta[name]
            setattr(self, name, tuple(v) if isinstance(v, (list, tuple)) else v)
        for name in LEAVES:
            self.register_buffer(name, torch.tensor(np.array(leaves[name]), dtype=dtype))

    @property
    def device(self):
        return self.qpos0.device

    def derived(self, key, make):
        """make(), computed once per device and kept on this model: the index
        tensors and constant rows the per-substep code reads, so that no
        call copies from the host (a copy from pageable host memory waits
        for the device). A planning model (replace) keeps its own."""
        cache = self.__dict__.setdefault("_derived", {})
        k = (str(self.device), key)
        if k not in cache:
            cache[k] = make()
        return cache[k]

    def replace(self, **static) -> "Model":
        """A model with some static fields changed (a planning model: its
        timestep, solver iterations, manifold cap) that shares this model's
        buffers. It starts with no cached kernel tables: they pack dt, the
        iteration counts and the row layout, so the two models must never
        share them."""
        unknown = set(static) - set(STATIC)
        if unknown:
            raise ValueError(f"Model.replace takes static fields only, not {sorted(unknown)}")
        new = Model.__new__(Model)
        nn.Module.__init__(new)
        for name in STATIC:
            setattr(new, name, static.get(name, getattr(self, name)))
        for name, buf in self.named_buffers():
            new.register_buffer(name, buf)
        return new

    # ---- name lookup -------------------------------------------------------
    def body_name2id(self, name: str) -> int:
        return self.body_names.index(name)

    def jnt_name2id(self, name: str) -> int:
        return self.jnt_names.index(name)

    def geom_name2id(self, name: str) -> int:
        return self.geom_names.index(name)

    def site_name2id(self, name: str) -> int:
        return self.site_names.index(name)

    def actuator_name2id(self, name: str) -> int:
        return self.actuator_names.index(name)

    def tendon_name2id(self, name: str) -> int:
        return self.tendon_names.index(name)

    def jnt_qpos_slice(self, name: str):
        j = self.jnt_name2id(name)
        return slice(self.jnt_qposadr[j], self.jnt_qposadr[j] + S.JOINT_NQ[self.jnt_type[j]])


# ---------------------------------------------------------------------------
# geometry -> inertia helpers (MuJoCo-equivalent analytic formulas)
# ---------------------------------------------------------------------------


def _geom_mass_inertia(g: S.GeomSpec, meshes=None):
    """(mass, COM-frame 3x3 inertia in the geom frame, COM offset in the
    geom frame) of a primitive or a hull-backed mesh geom."""
    m, I = _geom_mass_inertia_primitive(g, meshes)
    if S.GEOM_TYPES[g.type] == S.MESH and meshes and g.mesh in meshes:
        return m, I, np.asarray(meshes[g.mesh]["com"], dtype=np.float64)
    return m, I, np.zeros(3)


def _geom_mass_inertia_primitive(g: S.GeomSpec, meshes=None):
    t = S.GEOM_TYPES[g.type]
    if t == S.MESH and meshes and g.mesh in meshes:
        # the hull's exact mass properties (unit-density moments, scaled)
        h = meshes[g.mesh]
        vol = float(h["volume"])
        m = g.mass if g.mass is not None else g.density * vol
        return m, np.asarray(h["inertia"], dtype=np.float64) * ((m / vol) if vol > 0 else 0.0)
    sz = g.size  # each mass is density * volume, the volume first (the JAX package's rounding)
    if t == S.SPHERE:
        r = sz[0]
        m = g.mass if g.mass is not None else g.density * (4.0 / 3.0 * math.pi * r ** 3)
        i = 0.4 * m * r * r
        return m, np.diag([i, i, i])
    if t == S.BOX:
        hx, hy, hz = sz
        m = g.mass if g.mass is not None else g.density * (8.0 * hx * hy * hz)
        return m, np.diag(
            [m / 3.0 * (hy * hy + hz * hz), m / 3.0 * (hx * hx + hz * hz), m / 3.0 * (hx * hx + hy * hy)]
        )
    if t == S.CYLINDER:
        r, hl = sz[0], sz[1]
        m = g.mass if g.mass is not None else g.density * (math.pi * r * r * 2.0 * hl)
        ixx = m * (3.0 * r * r + 4.0 * hl * hl) / 12.0
        return m, np.diag([ixx, ixx, m * r * r / 2.0])
    if t == S.CAPSULE:
        r, hl = sz[0], sz[1]
        vc = math.pi * r * r * 2.0 * hl
        vs = 4.0 / 3.0 * math.pi * r ** 3
        rho = g.mass / (vc + vs) if g.mass is not None else g.density
        mc, ms = rho * vc, rho * vs
        L = 2.0 * hl
        izz = mc * r * r / 2.0 + ms * 2.0 * r * r / 5.0
        ixx = mc * (L * L / 12.0 + r * r / 4.0) + ms * (2.0 * r * r / 5.0 + L * L / 4.0 + 3.0 * L * r / 8.0)
        return mc + ms, np.diag([ixx, ixx, izz])
    if t == S.ELLIPSOID:
        a, b, c = sz
        m = g.mass if g.mass is not None else g.density * (4.0 / 3.0 * math.pi * a * b * c)
        return m, np.diag([m / 5.0 * (b * b + c * c), m / 5.0 * (a * a + c * c), m / 5.0 * (a * a + b * b)])
    # planes and meshes without a hull carry no computed inertia
    return 0.0, np.zeros((3, 3))


def _quat_mul_np(q1, q2):
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


def _quat2mat_np(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _mat2quat_np(m):
    tr = np.trace(m)
    if tr > 0:
        s = math.sqrt(tr + 1.0) * 2
        return np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = math.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    if q[0] < 0:
        q = -q
    return q / np.linalg.norm(q)


def _eig_principal(I):
    """Eigendecompose a 3x3 inertia (MuJoCo convention: already-diagonal
    tensors keep their axis order; otherwise principal moments sorted
    descending with a right-handed frame)."""
    off = abs(I[0, 1]) + abs(I[0, 2]) + abs(I[1, 2])
    if off < 1e-12 * max(np.trace(I), 1e-12):
        return np.diag(I).copy(), np.eye(3)
    w, v = np.linalg.eigh(I)
    order = np.argsort(w)[::-1]
    w = w[order]
    v = v[:, order]
    if np.linalg.det(v) < 0:
        v[:, 2] *= -1
    return w.copy(), v


def _body_inertial(body: S.BodySpec, meshes=None):
    """(mass, ipos, iquat, principal diag inertia) of a body: its explicit
    inertial, else accumulated over its group-0 primitive and hull geoms
    (MuJoCo compiler with robosuite's inertiagrouprange)."""
    if body.inertial is not None:
        it = body.inertial
        if it.fullinertia is not None:
            ixx, iyy, izz, ixy, ixz, iyz = it.fullinertia
            I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
            w, v = _eig_principal(I)
            return it.mass, it.pos.copy(), _mat2quat_np(_quat2mat_np(it.quat) @ v), w
        diag = it.diaginertia if it.diaginertia is not None else np.zeros(3)
        return it.mass, it.pos.copy(), it.quat.copy(), diag.copy()

    total_m = 0.0
    com = np.zeros(3)
    contributing = []
    for g in body.geoms:
        if g.group != 0:
            continue
        m, I_g, com_off = _geom_mass_inertia(g, meshes)
        if m <= 0:
            continue
        g_com = g.pos + _quat2mat_np(g.quat) @ com_off
        contributing.append((g, m, I_g, g_com))
        total_m += m
        com += m * g_com
    if total_m <= 0:
        # MuJoCo convention for massless (welded) bodies: ipos mirrors the
        # body's own frame offset
        return 0.0, np.asarray(body.pos, dtype=np.float64).copy(), np.array([1.0, 0, 0, 0]), np.zeros(3)
    com /= total_m
    I_total = np.zeros((3, 3))
    for g, m, I_g, g_com in contributing:
        R = _quat2mat_np(g.quat)
        d = g_com - com
        I_total += R @ I_g @ R.T + m * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
    w, v = _eig_principal(I_total)
    return total_m, com, _mat2quat_np(v), w


# a mesh geom collides only where its mesh has a hull (robot links keep
# their primitive collision shells; their meshes are visual)
_COLLIDABLE = {S.PLANE, S.SPHERE, S.CAPSULE, S.CYLINDER, S.BOX}


def _enumerate_pairs(geoms, geom_bodyid, body_parentid, body_weldid, excludes, body_name_to_id,
                     hullbacked=frozenset()):
    """MuJoCo-style static pair list (mj_collision's filters):
    contype/conaffinity, no same-weld pairs, no parent-child weld pairs
    unless the parent is the world, explicit <exclude> pairs."""
    excluded = set()
    for ex in excludes:
        b1 = body_name_to_id.get(ex.body1)
        b2 = body_name_to_id.get(ex.body2)
        if b1 is not None and b2 is not None:
            excluded.add((min(b1, b2), max(b1, b2)))

    nbody = len(body_parentid)
    weld_parent = [0] * nbody
    for b in range(1, nbody):
        if body_weldid[b] == b:
            weld_parent[b] = body_weldid[body_parentid[b]]
        else:
            weld_parent[b] = weld_parent[body_weldid[b]]

    def collidable(g, t):
        return g.mesh in hullbacked if t == S.MESH else t in _COLLIDABLE

    pairs = []
    for i, gi in enumerate(geoms):
        ti = S.GEOM_TYPES[gi.type]
        if not collidable(gi, ti):
            continue
        for j in range(i + 1, len(geoms)):
            gj = geoms[j]
            tj = S.GEOM_TYPES[gj.type]
            if not collidable(gj, tj) or (ti == S.PLANE and tj == S.PLANE):
                continue
            if not ((gi.contype & gj.conaffinity) or (gj.contype & gi.conaffinity)):
                continue
            b1, b2 = geom_bodyid[i], geom_bodyid[j]
            w1, w2 = body_weldid[b1], body_weldid[b2]
            if w1 == w2:
                continue
            if (weld_parent[w1] == w2 and w2 != 0) or (weld_parent[w2] == w1 and w1 != 0):
                continue
            if (min(b1, b2), max(b1, b2)) in excluded:
                continue
            pairs.append((i, j))
    return pairs


def _mix_pair_params(g1: S.GeomSpec, g2: S.GeomSpec):
    """MuJoCo contact parameter mixing (priority, else max friction and
    averaged solref/solimp; max margin)."""
    if g1.priority > g2.priority:
        return g1.friction.copy(), g1.solref.copy(), g1.solimp.copy(), max(g1.margin, g2.margin)
    if g2.priority > g1.priority:
        return g2.friction.copy(), g2.solref.copy(), g2.solimp.copy(), max(g1.margin, g2.margin)
    return (np.maximum(g1.friction, g2.friction), 0.5 * (g1.solref + g2.solref),
            0.5 * (g1.solimp + g2.solimp), max(g1.margin, g2.margin))


# ---------------------------------------------------------------------------
# the compiler
# ---------------------------------------------------------------------------


def _fixed_tendons(ms, joints, jnt_qposadr, jnt_dofadr, nq, nv, qpos0):
    """The fixed tendons' constant rows and parameters (MJCF <tendon><fixed>):
    -> (names, limited flags, leaves)."""
    jnt_id = {j.name: i for i, j in enumerate(joints)}
    nt = len(ms.tendons)
    out = dict(ten_J=np.zeros((nt, nv)), ten_Jq=np.zeros((nt, nq)), ten_range=np.zeros((nt, 2)),
               ten_stiffness=np.zeros(nt), ten_springlength=np.zeros(nt), ten_frictionloss=np.zeros(nt),
               ten_damping=np.zeros(nt), ten_length0=np.zeros(nt))
    for t_i, t in enumerate(ms.tendons):
        for jname, coef in zip(t.joints, t.coefs):
            if jname not in jnt_id:
                raise ValueError(f"tendon {t.name}: unknown joint {jname}")
            j = jnt_id[jname]
            if joints[j].type not in ("hinge", "slide"):
                raise ValueError(f"tendon {t.name}: fixed tendons couple scalar joints only")
            out["ten_J"][t_i, jnt_dofadr[j]] += coef
            out["ten_Jq"][t_i, jnt_qposadr[j]] += coef
        if t.range is not None:
            out["ten_range"][t_i] = t.range
        out["ten_stiffness"][t_i] = t.stiffness
        out["ten_frictionloss"][t_i] = t.frictionloss
        out["ten_damping"][t_i] = t.damping
        out["ten_length0"][t_i] = float(out["ten_Jq"][t_i] @ qpos0) if nq else 0.0
        # MJCF springlength -1 (None here): the spring rests at the qpos0 length
        out["ten_springlength"][t_i] = t.springlength if t.springlength is not None else out["ten_length0"][t_i]
    names = tuple(t.name for t in ms.tendons)
    if len(set(names)) != nt:
        raise ValueError("duplicate tendon names")
    return names, tuple(1 if t.limited else 0 for t in ms.tendons), out


def _equalities(ms, bodies, body_id, body_parentid, jnt_id, ten_id):
    """The equality constraints, names resolved; a connect's body2-frame
    anchor compiled from the qpos0 pose (MuJoCo's compiler): -> (kinds,
    obj1, obj2, leaves)."""
    neq = len(ms.equalities)
    kinds, obj1, obj2 = [], [], []
    out = dict(eq_anchor=np.zeros((neq, 3)), eq_anchor2=np.zeros((neq, 3)), eq_polycoef=np.zeros((neq, 5)),
               eq_solref=np.tile(np.array([0.02, 1.0]), (neq, 1)))
    nbody = len(bodies)
    xpos0, xquat0 = np.zeros((nbody, 3)), np.tile(np.array([1.0, 0, 0, 0]), (nbody, 1))
    for b in range(1, nbody):
        p = body_parentid[b]
        xpos0[b] = xpos0[p] + _quat2mat_np(xquat0[p]) @ bodies[b].pos
        xquat0[b] = _quat_mul_np(xquat0[p], bodies[b].quat)
    for i, eq in enumerate(ms.equalities):
        kinds.append(eq.kind)
        out["eq_solref"][i] = eq.solref
        if eq.kind in ("connect", "weld"):
            b1, b2 = body_id[eq.body1], (body_id[eq.body2] if eq.body2 else 0)
            obj1.append(b1)
            obj2.append(b2)
            out["eq_anchor"][i] = eq.anchor
            wa = xpos0[b1] + _quat2mat_np(xquat0[b1]) @ eq.anchor
            out["eq_anchor2"][i] = _quat2mat_np(xquat0[b2]).T @ (wa - xpos0[b2])
        elif eq.kind == "tendon":
            obj1.append(ten_id[eq.tendon1])
            obj2.append(ten_id[eq.tendon2] if eq.tendon2 else -1)
            out["eq_polycoef"][i] = eq.polycoef
        else:  # joint
            obj1.append(jnt_id[eq.joint1])
            obj2.append(jnt_id[eq.joint2] if eq.joint2 else -1)
            out["eq_polycoef"][i] = eq.polycoef
    return kinds, obj1, obj2, out


def compile_spec(ms: S.ModelSpec, dtype=np.float32) -> Model:
    bodies = ms.bodies()  # DFS order, world first — MuJoCo body ordering
    nbody = len(bodies)
    body_id = {b.name: i for i, b in enumerate(bodies)}
    assert len(body_id) == nbody, "duplicate body names"
    body_parentid = [0] * nbody
    for i, b in enumerate(bodies):
        for c in b.children:
            body_parentid[body_id[c.name]] = i

    joints, jnt_bodyid, body_jntadr, body_jntnum = [], [], [], []
    for i, b in enumerate(bodies):
        body_jntadr.append(len(joints) if b.joints else -1)
        body_jntnum.append(len(b.joints))
        for j in b.joints:
            joints.append(j)
            jnt_bodyid.append(i)
    njnt = len(joints)

    jnt_qposadr, jnt_dofadr, dof_bodyid, dof_jntid = [], [], [], []
    nq = nv = 0
    for jid, j in enumerate(joints):
        jnt_qposadr.append(nq)
        jnt_dofadr.append(nv)
        nq += j.nq
        nv += j.nv
        dof_bodyid += [jnt_bodyid[jid]] * j.nv
        dof_jntid += [jid] * j.nv

    # weld groups: bodies with no joints are welded to their parent
    body_weldid = [0] * nbody
    for i in range(1, nbody):
        body_weldid[i] = i if body_jntnum[i] > 0 else body_weldid[body_parentid[i]]

    geoms, geom_bodyid, sites, site_bodyid = [], [], [], []
    for i, b in enumerate(bodies):
        geoms += b.geoms
        geom_bodyid += [i] * len(b.geoms)
        sites += b.sites
        site_bodyid += [i] * len(b.sites)
    ngeom, nsite = len(geoms), len(sites)

    body_mass = np.zeros(nbody)
    body_ipos = np.zeros((nbody, 3))
    body_iquat = np.tile(np.array([1.0, 0, 0, 0]), (nbody, 1))
    body_inertia = np.zeros((nbody, 3))
    for i, b in enumerate(bodies[1:], start=1):
        body_mass[i], body_ipos[i], body_iquat[i], body_inertia[i] = _body_inertial(b, ms.meshes)

    qpos0 = np.zeros(nq)
    qpos_spring = np.zeros(nq)
    jnt_stiffness = np.zeros(njnt)
    for jid, j in enumerate(joints):
        t = S.JOINT_TYPES[j.type]
        adr = jnt_qposadr[jid]
        if t == S.FREE:
            # free-joint qpos is the body's world pose, composed through
            # the ancestor chain
            chain = []
            bi = jnt_bodyid[jid]
            while bi != 0:
                chain.append(bi)
                bi = body_parentid[bi]
            w_pos, w_quat = np.zeros(3), np.array([1.0, 0.0, 0.0, 0.0])
            for bi in reversed(chain):
                w_pos = w_pos + _quat2mat_np(w_quat) @ np.asarray(bodies[bi].pos, dtype=np.float64)
                w_quat = _quat_mul_np(w_quat, np.asarray(bodies[bi].quat, dtype=np.float64))
            qpos0[adr: adr + 3] = w_pos
            qpos0[adr + 3: adr + 7] = w_quat
            qpos_spring[adr: adr + 7] = qpos0[adr: adr + 7]
        elif t == S.BALL:
            qpos0[adr] = qpos_spring[adr] = 1.0
        else:
            qpos0[adr] = j.ref
            qpos_spring[adr] = j.springref
        jnt_stiffness[jid] = j.stiffness

    # float32 conditioning: an armature floor on hinge/slide dofs keeps the
    # f32 mass matrix positive definite next to gram-scale finger links
    ARMATURE_FLOOR = 1e-5
    dof_damping, dof_armature, dof_frictionloss = np.zeros(nv), np.zeros(nv), np.zeros(nv)
    for jid, j in enumerate(joints):
        adr = jnt_dofadr[jid]
        floor = ARMATURE_FLOOR if j.type in ("hinge", "slide") else 0.0
        for k in range(j.nv):
            dof_damping[adr + k] = j.damping
            dof_armature[adr + k] = max(j.armature, floor)
            dof_frictionloss[adr + k] = j.frictionloss

    jnt_id = {j.name: i for i, j in enumerate(joints)}
    tendon_names, tendon_limited, tendon_leaves = _fixed_tendons(ms, joints, jnt_qposadr, jnt_dofadr, nq, nv, qpos0)
    ten_id = {n: i for i, n in enumerate(tendon_names)}
    nu = len(ms.actuators)
    actuator_jntid, actuator_tenid = [], []
    actuator_gear = np.ones(nu)
    actuator_ctrlrange = np.zeros((nu, 2))
    actuator_forcerange = np.zeros((nu, 2))
    actuator_gainprm = np.zeros(nu)
    actuator_biasprm = np.zeros((nu, 3))
    actuator_ctrllimited = np.zeros(nu)
    actuator_forcelimited = np.zeros(nu)
    for a_i, a in enumerate(ms.actuators):
        if a.tendon is not None:
            if a.tendon not in ten_id:
                raise ValueError(f"actuator {a.name}: unknown tendon {a.tendon}")
            actuator_jntid.append(-1)
            actuator_tenid.append(ten_id[a.tendon])
        else:
            actuator_jntid.append(jnt_id[a.joint])
            actuator_tenid.append(-1)
        actuator_gear[a_i] = a.gear
        if a.ctrlrange is not None:
            actuator_ctrlrange[a_i] = a.ctrlrange
            actuator_ctrllimited[a_i] = 1.0
        if a.forcerange is not None:
            actuator_forcerange[a_i] = a.forcerange
            actuator_forcelimited[a_i] = 1.0
        if a.kind == "general":  # fixed gain, affine bias
            actuator_gainprm[a_i] = a.gainprm
            actuator_biasprm[a_i] = a.biasprm
        else:
            actuator_gainprm[a_i] = a.kp if a.kind == "position" else (a.kv if a.kind == "velocity" else 0.0)

    # convex hulls (the meshes with hull data)
    hull_names = sorted(ms.meshes)
    mesh_id = {n: i for i, n in enumerate(hull_names)}
    nmesh = len(hull_names)
    V = max([len(ms.meshes[n]["verts"]) for n in hull_names], default=1)
    F = max([len(ms.meshes[n]["face_dists"]) for n in hull_names], default=1)
    mesh_verts = np.zeros((nmesh, V, 3))
    mesh_fnorm = np.tile(np.array([0.0, 0.0, 1.0]), (nmesh, F, 1))
    mesh_fdist = np.full((nmesh, F), 1e6)
    for n, mi in mesh_id.items():
        h = ms.meshes[n]
        v = np.asarray(h["verts"], dtype=np.float64)
        mesh_verts[mi, :len(v)] = v
        mesh_verts[mi, len(v):] = v[0]
        fd = np.asarray(h["face_dists"], dtype=np.float64)
        mesh_fnorm[mi, :len(fd)] = np.asarray(h["face_normals"], dtype=np.float64)
        mesh_fdist[mi, :len(fd)] = fd
    geom_meshid = [mesh_id.get(g.mesh, -1) if S.GEOM_TYPES[g.type] == S.MESH else -1 for g in geoms]

    pairs = _enumerate_pairs(geoms, geom_bodyid, body_parentid, body_weldid, ms.excludes, body_id,
                             hullbacked=set(mesh_id))
    npair = len(pairs)
    pair_friction = np.zeros((npair, 3))
    pair_solref = np.zeros((npair, 2))
    pair_solimp = np.zeros((npair, 5))
    pair_margin = np.zeros(npair)
    for p, (i, j) in enumerate(pairs):
        pair_friction[p], pair_solref[p], pair_solimp[p], pair_margin[p] = _mix_pair_params(geoms[i], geoms[j])

    eq_kind, eq_obj1, eq_obj2, eq_leaves = _equalities(ms, bodies, body_id, body_parentid, jnt_id, ten_id)

    # ancestor mask: dof d moves body b iff d's joint body is an ancestor of b
    ancestor_mask = np.zeros((nbody, nv))
    for b in range(1, nbody):
        chain = set()
        anc = b
        while anc != 0:
            chain.add(anc)
            anc = body_parentid[anc]
        for d in range(nv):
            if dof_bodyid[d] in chain:
                ancestor_mask[b, d] = 1.0

    def names_of(elems):
        out = tuple(e.name for e in elems)
        assert len(set(out)) == len(out), f"duplicate names: {sorted(out)}"
        return out

    def stack(rows, width):
        return np.stack(rows) if rows else np.zeros((0, width))

    meta = dict(
        nq=nq, nv=nv, nu=nu, nbody=nbody, njnt=njnt, ngeom=ngeom, nsite=nsite, npair=npair,
        body_parentid=body_parentid, body_jntadr=body_jntadr, body_jntnum=body_jntnum,
        body_weldid=body_weldid, jnt_type=[S.JOINT_TYPES[j.type] for j in joints],
        jnt_bodyid=jnt_bodyid, jnt_qposadr=jnt_qposadr, jnt_dofadr=jnt_dofadr,
        dof_bodyid=dof_bodyid, dof_jntid=dof_jntid, geom_bodyid=geom_bodyid,
        geom_type=[S.GEOM_TYPES[g.type] for g in geoms], site_bodyid=site_bodyid,
        actuator_kind=[a.kind for a in ms.actuators], actuator_jntid=actuator_jntid, actuator_tenid=actuator_tenid,
        ntendon=len(tendon_names), tendon_names=tendon_names, tendon_limited=tendon_limited,
        neq=len(eq_kind), eq_kind=eq_kind, eq_obj1=eq_obj1, eq_obj2=eq_obj2,
        pair_geom1=[p[0] for p in pairs], pair_geom2=[p[1] for p in pairs],
        nmesh=nmesh, mesh_names=tuple(hull_names), geom_meshid=geom_meshid,
        body_names=names_of(bodies), jnt_names=names_of(joints), geom_names=names_of(geoms),
        site_names=names_of(sites), actuator_names=tuple(a.name for a in ms.actuators),
        timestep=float(ms.option.timestep), impratio=float(ms.option.impratio),
        solver_iters=None, solver_power_iters=None, pair_points_cap=None,
    )
    leaves = dict(
        body_pos=np.stack([b.pos for b in bodies]), body_quat=np.stack([b.quat for b in bodies]),
        body_ipos=body_ipos, body_iquat=body_iquat, body_mass=body_mass, body_inertia=body_inertia,
        jnt_pos=stack([j.pos for j in joints], 3), jnt_axis=stack([j.axis for j in joints], 3),
        jnt_range=stack([j.range if j.range is not None else np.zeros(2) for j in joints], 2),
        jnt_limited=np.array([1.0 if j.limited else 0.0 for j in joints]),
        jnt_stiffness=jnt_stiffness, dof_damping=dof_damping, dof_armature=dof_armature,
        dof_frictionloss=dof_frictionloss,
        geom_pos=stack([g.pos for g in geoms], 3), geom_quat=stack([g.quat for g in geoms], 4),
        geom_size=stack([g.size for g in geoms], 3), geom_friction=stack([g.friction for g in geoms], 3),
        geom_margin=np.array([g.margin for g in geoms]),
        site_pos=stack([s.pos for s in sites], 3), site_quat=stack([s.quat for s in sites], 4),
        actuator_gear=actuator_gear, actuator_ctrlrange=actuator_ctrlrange,
        actuator_forcerange=actuator_forcerange, actuator_gainprm=actuator_gainprm,
        actuator_biasprm=actuator_biasprm, actuator_ctrllimited=actuator_ctrllimited,
        actuator_forcelimited=actuator_forcelimited,
        pair_friction=pair_friction, pair_solref=pair_solref, pair_solimp=pair_solimp,
        pair_margin=pair_margin, mesh_verts=mesh_verts, mesh_fnorm=mesh_fnorm, mesh_fdist=mesh_fdist, qpos0=qpos0, qpos_spring=qpos_spring,
        gravity=np.asarray(ms.option.gravity), ancestor_mask=ancestor_mask, **tendon_leaves, **eq_leaves,
    )
    leaves = {k: np.asarray(v, dtype=dtype) for k, v in leaves.items()}
    return Model(leaves, meta)
