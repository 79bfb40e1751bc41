"""Contact: static pair layout, narrowphase and the solver's row assembly,
on batched tensors (the JAX package's physics/contact.py, for the pair
types of the Lift, Stack, Door and PickPlace worlds: plane against
sphere, cylinder, box and hull; sphere against sphere, cylinder, box and
hull; cylinder against cylinder, box and hull; box against box and hull;
hull against hull).

The primitive formulas are the JAX package's lane formulas
(ops/pallas_substep.py _np_* — what its narrowphase runs for primitive
pairs): every quantity is a tuple of per-component tensors of shape
(B, P), one entry per scenario and pair of a type group. The CUDA
narrowphase (csrc/narrowphase.cuh) evaluates the same formulas for the
pair types the fused substep takes. The convex-hull formulas (a mesh geom
with hull data: vertices and outward face planes in the geom frame) are
the JAX package's vmapped _*_hull functions, on (B, P, ...) tensors.

Rows are GROUP-major: pair groups sorted by (type1, type2), pairs in model
order within a group, MANIFOLD_CAP deepest points per pair. A world whose
static rows would not fit the JAX package's VMEM solver
(uses_row_compaction: PickPlace) compacts its active rows into ROW_CAP
slots before the solve.
"""

from __future__ import annotations

import torch

from robosuite_tpu_torch.models import spec as S
from robosuite_tpu_torch.ops import tangent

APGD_ITERS = 30
POWER_ITERS = 8
MANIFOLD_CAP = 4
_BIG = 1e4

# candidate points per pair, by (type1, type2) with type1 <= type2
_PAIR_POINTS = {
    (S.PLANE, S.SPHERE): 1,
    (S.PLANE, S.CYLINDER): 3,
    (S.PLANE, S.BOX): 8,
    (S.SPHERE, S.SPHERE): 1,
    (S.SPHERE, S.CYLINDER): 1,
    (S.SPHERE, S.BOX): 1,
    (S.CYLINDER, S.CYLINDER): 1,
    (S.CYLINDER, S.BOX): 2,
    (S.BOX, S.BOX): 25,  # 16 two-way vertex tests + 9 SAT edge-cross rows
    # convex hulls
    (S.PLANE, S.MESH): 4,
    (S.SPHERE, S.MESH): 1,
    (S.CYLINDER, S.MESH): 2,
    (S.BOX, S.MESH): 12,
    (S.MESH, S.MESH): 8,
}

# Worlds whose static rows would not fit the JAX package's VMEM solver
# (nv * 3 rows > ROW_VMEM_BUDGET) compact their active rows into ROW_CAP
# slots (its contact.py uses_row_compaction); the same predicate keeps
# them off the fused substep.
ROW_CAP = 96
ROW_VMEM_BUDGET = 8000


def pair_points(t1: int, t2: int) -> int:
    """Points per pair after the manifold cut (the solver's row count)."""
    key = (min(t1, t2), max(t1, t2))
    if key not in _PAIR_POINTS:
        raise NotImplementedError(f"pair type {key} is not ported")
    return min(_PAIR_POINTS[key], MANIFOLD_CAP)


def model_pair_points(model, t1: int, t2: int) -> int:
    """Points per pair for this model: Model.pair_points_cap (a planning
    model's reduced manifolds) tightens MANIFOLD_CAP."""
    n = pair_points(t1, t2)
    cap = model.pair_points_cap
    if cap is None:
        return n
    if cap < 1:
        raise ValueError(f"pair_points_cap must be >= 1 (got {cap})")
    return min(n, cap)


def solver_iterations(model):
    """(APGD iterations, power iterations) of the model's contact solve."""
    iters = APGD_ITERS if model.solver_iters is None else model.solver_iters
    piters = POWER_ITERS if model.solver_power_iters is None else model.solver_power_iters
    return iters, piters


def pair_groups(model, pairs=None):
    """{(t1, t2): [(g1, g2, pair, flip), ...]} with t1 <= t2, pairs in
    model order; `pairs` restricts to a subset of pair indices."""
    groups: dict = {}
    for k in range(model.npair):
        if pairs is not None and k not in pairs:
            continue
        g1, g2 = model.pair_geom1[k], model.pair_geom2[k]
        t1, t2 = model.geom_type[g1], model.geom_type[g2]
        flip = t1 > t2
        if flip:
            g1, g2, t1, t2 = g2, g1, t2, t1
        groups.setdefault((t1, t2), []).append((g1, g2, k, flip))
    return groups


def contact_row_layout(model):
    """{pair index: [row, ...]}: THE row order of the contact buffer."""
    rows, row = {}, 0
    for key, items in sorted(pair_groups(model).items()):
        npts = model_pair_points(model, *key)
        for _, _, k, _ in items:
            rows[k] = list(range(row, row + npts))
            row += npts
    return rows


# ---------------------------------------------------------------------------
# component-tuple vector algebra (each component is a (B, P) tensor)
# ---------------------------------------------------------------------------


def _add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _scale(s, a):
    return (s * a[0], s * a[1], s * a[2])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def _norm3(v):
    return torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])


def _matcol(R, i):
    return (R[0][i], R[1][i], R[2][i])


def _mat_vec(R, v):
    return tuple(R[i][0] * v[0] + R[i][1] * v[1] + R[i][2] * v[2] for i in range(3))


def _matT_vec(R, v):
    return tuple(R[0][i] * v[0] + R[1][i] * v[1] + R[2][i] * v[2] for i in range(3))


_CORNERS = [(sx, sy, sz) for sx in (-1.0, 1.0) for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)]


def _point_box(pl, half):
    """Signed distance from a box surface to a local point + outward local
    normal; inside, the normal is a softmax blend of the face normals
    (temperature 2 mm) so it cannot flicker between faces."""
    q = [torch.abs(pl[i]) - half[i] for i in range(3)]
    outside = [torch.clamp_min(q[i], 0.0) for i in range(3)]
    d_out = _norm3(outside)
    d_in = torch.maximum(torch.maximum(q[0], q[1]), q[2])
    inside = d_out < 1e-9
    d = torch.where(inside, d_in, d_out)
    n_out = [torch.sign(pl[i]) * outside[i] / torch.clamp_min(d_out, 1e-9) for i in range(3)]
    e = [torch.exp((q[i] - d_in) / 2e-3) for i in range(3)]
    se = e[0] + e[1] + e[2]
    n_in_raw = [torch.sign(pl[i]) * (e[i] / se) for i in range(3)]
    nn = torch.clamp_min(_norm3(n_in_raw), 1e-9)
    n = tuple(torch.where(inside, n_in_raw[i] / nn, n_out[i]) for i in range(3))
    return d, n


def _np_plane_box(p1, R1, s1, p2, R2, s2):
    n = tuple(x[..., None] for x in _matcol(R1, 2))
    pt = _box_corners(p2, R2, s2)
    d = _dot(_sub(pt, tuple(x[..., None] for x in p1)), n)
    return _split(d, _sub(pt, _scale(0.5 * d, n)), n)


def _np_plane_cylinder(p1, R1, s1, p2, R2, s2):
    """Plane vs cylinder: both cap rims at their point nearest the plane
    (the rim direction is the plane normal's descent across the cap, the
    cylinder's x axis where its axis is parallel to the normal) and the
    centre of the +z cap."""
    n = _matcol(R1, 2)
    axis = _matcol(R2, 2)
    an = _dot(axis, n)
    proj = _sub(n, _scale(an, axis))
    pn = _norm3(proj)
    good = pn > 1e-8
    inv = 1.0 / torch.clamp_min(pn, 1e-8)
    rx = _matcol(R2, 0)
    rim = tuple(torch.where(good, -proj[i] * inv, rx[i]) for i in range(3))
    pts = [
        _add(_add(p2, _scale(s2[1], axis)), _scale(s2[0], rim)),
        _add(_sub(p2, _scale(s2[1], axis)), _scale(s2[0], rim)),
        _add(p2, _scale(s2[1], axis)),
    ]
    out = []
    for pt in pts:
        d = _dot(_sub(pt, p1), n)
        out.append((d, _sub(pt, _scale(0.5 * d, n)), n))
    return out


def _np_capsule_capsule(p1, R1, s1, p2, R2, s2):
    """Capsule vs capsule (cylinder-cylinder runs as it): the closest points
    of the two axis segments, the segment parameters clamped to [0, 1]
    (s from the unclamped solution, t from s, s again from t)."""
    a0 = _sub(p1, _scale(s1[1], _matcol(R1, 2)))
    a1 = _add(p1, _scale(s1[1], _matcol(R1, 2)))
    b0 = _sub(p2, _scale(s2[1], _matcol(R2, 2)))
    b1 = _add(p2, _scale(s2[1], _matcol(R2, 2)))
    da = _sub(a1, a0)
    db = _sub(b1, b0)
    r = _sub(a0, b0)
    A = _dot(da, da) + 1e-12
    B = _dot(da, db)
    Cc = _dot(db, db) + 1e-12
    D = _dot(da, r)
    E = _dot(db, r)
    den = A * Cc - B * B
    s = torch.clamp(torch.where(den > 1e-12, (B * E - Cc * D) / torch.clamp_min(den, 1e-12), torch.zeros_like(den)),
                    0.0, 1.0)
    t = torch.clamp((B * s + E) / Cc, 0.0, 1.0)
    s = torch.clamp((B * t - D) / A, 0.0, 1.0)
    pa = _add(a0, _scale(s, da))
    pb = _add(b0, _scale(t, db))
    dp = _sub(pb, pa)
    dist = _norm3(dp)
    n = _scale(1.0 / torch.clamp_min(dist, 1e-9), dp)
    d = dist - s1[0] - s2[0]
    return [(d, _add(pa, _scale(s1[0] + 0.5 * d, n)), n)]


def _np_capsule_box(p1, R1, s1, p2, R2, s2):
    """Capsule (or cylinder, as a capsule) vs box: both segment ends
    against the box."""
    out = []
    for sgn in (-1.0, 1.0):
        e = _add(p1, _scale(sgn * s1[1], _matcol(R1, 2)))
        d_surf, n_l = _point_box(_matT_vec(R2, _sub(e, p2)), s2)
        n_w = tuple(-x for x in _mat_vec(R2, n_l))
        d = d_surf - s1[0]
        out.append((d, _add(e, _scale(s1[0] + 0.5 * d, n_w)), n_w))
    return out


# The candidates of a type group that are evaluated together along a last
# axis (a box's 8 corners, the 9 edge pairs): each is the same arithmetic,
# element by element, as one candidate alone, in fewer and larger kernels.
_CONSTS = {}


def _const(name, like):
    """A small constant tensor on `like`'s device and dtype, made once:
    "signs" (3, 8), each axis's corner signs in _CORNERS order; "edge_i",
    "edge_j" (3, 9), 1 where the edge pair (i, j) (i-major) leaves axis k
    free, as box_box_sat's offsets o1 (k != i) and o2 (k != j) need."""
    key = (name, like.device, like.dtype)
    if key not in _CONSTS:
        if name == "signs":
            v = [[c[k] for c in _CORNERS] for k in range(3)]
        else:
            v = [[float(k != (e // 3 if name == "edge_i" else e % 3)) for e in range(9)] for k in range(3)]
        _CONSTS[key] = torch.tensor(v, dtype=like.dtype, device=like.device)
    return _CONSTS[key]


def _ex(v):
    """A vector's components (or a matrix's rows of components) with a
    trailing axis of 1, to meet a candidate axis."""
    if isinstance(v[0], (list, tuple)):
        return [[x[..., None] for x in row] for row in v]
    return tuple(x[..., None] for x in v)


def _split(d, pos, n):
    """Candidates stacked along the last axis -> the list of (d, pos, n)
    (a component with an axis of 1 is every candidate's)."""
    pos, n = (tuple(torch.broadcast_to(x, d.shape) for x in v) for v in (pos, n))
    return [(d[..., e], tuple(x[..., e] for x in pos), tuple(x[..., e] for x in n)) for e in range(d.shape[-1])]


def _box_corners(p, R, s):
    """A box's 8 corners in the world, in _CORNERS order along a last axis."""
    sg = _const("signs", p[0])
    off = tuple(sg[k] * s[k][..., None] for k in range(3))
    return _add(_ex(p), _mat_vec(_ex(R), off))


def _np_box_box(p1, R1, s1, p2, R2, s2):
    pt = _box_corners(p1, R1, s1)  # corners of box1 vs box2
    d1, n_l = _point_box(_matT_vec(_ex(R2), _sub(pt, _ex(p2))), _ex(s2))
    nw = tuple(-x for x in _mat_vec(_ex(R2), n_l))
    out = _split(d1, _add(pt, _scale(0.5 * d1, nw)), nw)
    pt = _box_corners(p2, R2, s2)  # corners of box2 vs box1 (normal from box1 toward box2)
    d2, n_l = _point_box(_matT_vec(_ex(R1), _sub(pt, _ex(p1))), _ex(s1))
    nw = _mat_vec(_ex(R1), n_l)
    out += _split(d2, _add(pt, _scale(-0.5 * d2, nw)), nw)
    return out + _np_box_box_edges(p1, R1, s1, p2, R2, s2)


def _np_box_box_edges(p1, R1, s1, p2, R2, s2):
    """9 SAT edge-cross rows (MuJoCo mjc_BoxBox edge case), masked to +BIG
    unless the global separating axis is that edge pair's cross axis and
    it beats every face axis."""
    max_face, best_e, sep, pos, axis, valid = _box_box_sat_lanes(p1, R1, s1, p2, R2, s2)
    emit = valid & (sep >= best_e[..., None] - 1e-9) & (sep > max_face[..., None])
    return _split(torch.where(emit, sep, torch.full_like(sep, _BIG)), pos, axis)


def box_box_sat(p1, R1, s1, p2, R2, s2):
    """The separating-axis test of two boxes: (max_face, the largest face
    separation; best_e, the largest edge-cross separation; the 9 edge-cross
    candidates (sep, pos, axis, valid), sep unmasked). An edge candidate is
    emitted only where best_e beats max_face, so a near-tie of the two
    decides whether the pair's minimum distance includes an edge point."""
    max_face, best_e, sep, pos, axis, valid = _box_box_sat_lanes(p1, R1, s1, p2, R2, s2)
    cands = [(sep[..., e], tuple(x[..., e] for x in pos), tuple(x[..., e] for x in axis), valid[..., e])
             for e in range(9)]
    return max_face, best_e, cands


def _box_box_sat_lanes(p1, R1, s1, p2, R2, s2):
    """box_box_sat with the 9 edge pairs (i, j), i-major, along a last axis:
    (max_face, best_e, sep, pos, axis, valid)."""
    dp = _sub(p2, p1)
    a_axes = [_matcol(R1, i) for i in range(3)]
    b_axes = [_matcol(R2, j) for j in range(3)]

    def face_seps(axes, h_self, other_axes, h_other):
        out = []
        for k in range(3):
            ax = axes[k]
            proj_o = sum(h_other[m] * torch.abs(_dot(ax, other_axes[m])) for m in range(3))
            out.append(torch.abs(_dot(ax, dp)) - h_self[k] - proj_o)
        return out

    seps_f = face_seps(a_axes, s1, b_axes, s2) + face_seps(b_axes, s2, a_axes, s1)
    max_face = seps_f[0]
    for s in seps_f[1:]:
        max_face = torch.maximum(max_face, s)

    ii, jj = [e // 3 for e in range(9)], [e % 3 for e in range(9)]
    a = tuple(torch.stack([a_axes[i][c] for i in ii], dim=-1) for c in range(3))
    b = tuple(torch.stack([b_axes[j][c] for j in jj], dim=-1) for c in range(3))
    dpx, p1x, p2x = _ex(dp), _ex(p1), _ex(p2)
    ax_a, ax_b = [_ex(v) for v in a_axes], [_ex(v) for v in b_axes]
    s1x, s2x = [x[..., None] for x in s1], [x[..., None] for x in s2]
    axis = _cross(a, b)
    nrm = _norm3(axis)
    valid = nrm > 1e-6
    axis = _scale(1.0 / torch.clamp_min(nrm, 1e-6), axis)
    sgn = torch.where(_dot(axis, dpx) < 0.0, -torch.ones_like(nrm), torch.ones_like(nrm))
    axis = _scale(sgn, axis)
    proj1 = sum(s1x[k] * torch.abs(_dot(axis, ax_a[k])) for k in range(3))
    proj2 = sum(s2x[k] * torch.abs(_dot(axis, ax_b[k])) for k in range(3))
    sep = _dot(axis, dpx) - proj1 - proj2
    sep = torch.where(valid, sep, torch.full_like(sep, -float("inf")))
    # the supporting edges' offsets: box1 along +axis over its axes k != i,
    # box2 along -axis over k != j (a masked term adds exactly 0)
    free_i, free_j = _const("edge_i", sep), _const("edge_j", sep)
    o1 = (0.0, 0.0, 0.0)
    o2 = (0.0, 0.0, 0.0)
    for k in range(3):
        o1 = _add(o1, _scale(free_i[k], _scale(torch.sign(_dot(axis, ax_a[k])) * s1x[k], ax_a[k])))
        o2 = _sub(o2, _scale(free_j[k], _scale(torch.sign(_dot(axis, ax_b[k])) * s2x[k], ax_b[k])))
    c1 = _add(p1x, o1)
    c2 = _add(p2x, o2)
    r = _sub(c2, c1)
    ab = _dot(a, b)
    den = torch.clamp_min(1.0 - ab * ab, 1e-9)
    s1i = torch.stack([s1[i] for i in ii], dim=-1)
    s2j = torch.stack([s2[j] for j in jj], dim=-1)
    t1 = torch.clamp((_dot(a, r) - ab * _dot(b, r)) / den, -s1i, s1i)
    t2 = torch.clamp((ab * _dot(a, r) - _dot(b, r)) / den, -s2j, s2j)
    q1 = _add(c1, _scale(t1, a))
    q2 = _add(c2, _scale(t2, b))
    return max_face, sep.amax(dim=-1), sep, _scale(0.5, _add(q1, q2)), axis, valid


def _np_plane_sphere(p1, R1, s1, p2, R2, s2):
    n = _matcol(R1, 2)
    d = _dot(_sub(p2, p1), n) - s2[0]
    return [(d, _sub(p2, _scale(s2[0] + 0.5 * d, n)), n)]


def _np_sphere_sphere(p1, R1, s1, p2, R2, s2):
    dp = _sub(p2, p1)
    dist = _norm3(dp)
    n = _scale(1.0 / torch.clamp_min(dist, 1e-9), dp)
    d = dist - s1[0] - s2[0]
    return [(d, _add(p1, _scale(s1[0] + 0.5 * d, n)), n)]


def _np_sphere_capsule(p1, R1, s1, p2, R2, s2):
    """Sphere vs capsule (sphere-cylinder runs as it): the sphere centre
    against the capsule's axis segment."""
    axis = _matcol(R2, 2)
    t = torch.clamp(_dot(_sub(p1, p2), axis), -s2[1], s2[1])
    dp = _sub(_add(p2, _scale(t, axis)), p1)
    dist = _norm3(dp)
    n = _scale(1.0 / torch.clamp_min(dist, 1e-9), dp)
    d = dist - s1[0] - s2[0]
    return [(d, _add(p1, _scale(s1[0] + 0.5 * d, n)), n)]


def _np_sphere_box(p1, R1, s1, p2, R2, s2):
    d_surf, n_l = _point_box(_matT_vec(R2, _sub(p1, p2)), s2)
    n_w = tuple(-x for x in _mat_vec(R2, n_l))
    d = d_surf - s1[0]
    return [(d, _add(p1, _scale(s1[0] + 0.5 * d, n_w)), n_w)]


_LANE_DISPATCH = {
    (S.PLANE, S.SPHERE): _np_plane_sphere,
    (S.PLANE, S.CYLINDER): _np_plane_cylinder,
    (S.PLANE, S.BOX): _np_plane_box,
    (S.SPHERE, S.SPHERE): _np_sphere_sphere,
    (S.SPHERE, S.CYLINDER): _np_sphere_capsule,
    (S.SPHERE, S.BOX): _np_sphere_box,
    (S.CYLINDER, S.CYLINDER): _np_capsule_capsule,
    (S.CYLINDER, S.BOX): _np_capsule_box,
    (S.BOX, S.BOX): _np_box_box,
}


# ---------------------------------------------------------------------------
# convex hulls: a hull operand is (verts (P, V, 3), face normals (P, F, 3),
# face offsets (P, F)) in the geom frame, padded as Model.mesh_* are; poses
# p (B, P, 3), R (B, P, 3, 3), sizes s (P, 3). Each returns (d (B, P, n),
# pos (B, P, n, 3), normal (B, P, n, 3)), the normal from geom1 into geom2.
# The "maxplane" distance max_f(n_f . p - d_f) is exact for penetrating
# points and a smooth underestimate outside; its normal is a softmax blend
# of the face normals (temperature 2 mm), as _point_box's.
# ---------------------------------------------------------------------------


def _rot(R, v):
    """R v for R (B, P, 3, 3) and v (B, P, ..., 3)."""
    return torch.einsum("bpij,bp...j->bp...i", R, v)


def _rotT(R, v):
    """R^T v."""
    return torch.einsum("bpji,bp...j->bp...i", R, v)


def _world(p, R, local):
    """Points of a geom's frame (P, n, 3) in the world: (B, P, n, 3)."""
    return p[:, :, None] + torch.einsum("bpij,pnj->bpni", R, local)


def _point_hull(pl, fnorm, fdist):
    """Signed maxplane distance (B, P, n) of hull-frame points pl (B, P, n,
    3) and the blended outward normal (hull frame)."""
    s_ = torch.einsum("pfj,bpnj->bpnf", fnorm, pl) - fdist[None, :, None]
    d = s_.max(dim=-1).values
    w = torch.softmax(s_ / 2e-3, dim=-1)
    n = torch.einsum("bpnf,pfj->bpnj", w, fnorm)
    return d, n / torch.clamp_min(torch.linalg.vector_norm(n, dim=-1, keepdim=True), 1e-9)


def _take(k, d, *vecs):
    """The k deepest of d (B, P, n) (select_deepest), with the same rows of
    each (B, P, n, 3) in vecs."""
    idx = select_deepest(d, k)
    i3 = idx[..., None].expand(idx.shape + (3,))
    return (torch.gather(d, -1, idx), *(torch.gather(v, -2, i3) for v in vecs))


def _plane_hull(p1, R1, s1, p2, R2, h2):
    """The hull's 4 deepest vertices below the plane."""
    n = R1[..., 2]
    vw = _world(p2, R2, h2[0])
    d, vw = _take(4, torch.einsum("bpvi,bpi->bpv", vw - p1[:, :, None], n), vw)
    nb = n[:, :, None].expand(vw.shape)
    return d, vw - nb * (0.5 * d[..., None]), nb


def _sphere_hull(p1, R1, s1, p2, R2, h2):
    d_surf, n_l = _point_hull(_rotT(R2, p1 - p2)[:, :, None], h2[1], h2[2])
    n_w = -_rot(R2, n_l)
    d = d_surf - s1[:, 0, None]
    return d, p1[:, :, None] + n_w * (s1[:, 0, None, None] + 0.5 * d[..., None]), n_w


def _capsule_hull(p1, R1, s1, p2, R2, h2):
    """Both ends of the capsule's (or cylinder's) axis segment against the
    hull's faces."""
    ends = torch.stack([p1 - R1[..., 2] * s1[:, 1, None], p1 + R1[..., 2] * s1[:, 1, None]], dim=2)
    d_surf, n_l = _point_hull(_rotT(R2, ends - p2[:, :, None]), h2[1], h2[2])
    n_w = -_rot(R2, n_l)
    d = d_surf - s1[:, 0, None]
    return d, ends + n_w * (s1[:, 0, None, None] + 0.5 * d[..., None]), n_w


def _box_hull(p1, R1, s1, p2, R2, h2):
    """Two-way vertex tests: the hull's 4 deepest vertices in the box, then
    the box's 8 corners against the hull's faces."""
    verts, fn_, fd_ = h2
    vw = _world(p2, R2, verts)
    vl = _rotT(R1, vw - p1[:, :, None])
    half = tuple(s1[:, None, i] for i in range(3))
    d1, n1 = _point_box(tuple(vl[..., i] for i in range(3)), half)
    nw1 = _rot(R1, torch.stack(n1, dim=-1))  # from the box into the hull
    d1, nw1, vw1 = _take(4, d1, nw1, vw)
    corners = _const("signs", s1).T[None] * s1[:, None]
    cw = _world(p1, R1, corners)
    d2, n2 = _point_hull(_rotT(R2, cw - p2[:, :, None]), fn_, fd_)
    nw2 = -_rot(R2, n2)
    return (torch.cat([d1, d2], dim=-1), torch.cat([vw1 - nw1 * (0.5 * d1[..., None]),
                                                    cw + nw2 * (0.5 * d2[..., None])], dim=-2),
            torch.cat([nw1, nw2], dim=-2))


def _hull_hull(p1, R1, h1, p2, R2, h2):
    """Each hull's 4 deepest vertices against the other's face planes."""

    def verts_vs(pv, Rv, verts, pf, Rf, fn_, fd_, sign):
        vw = _world(pv, Rv, verts)
        d, n = _point_hull(_rotT(Rf, vw - pf[:, :, None]), fn_, fd_)
        d, nw, vw = _take(4, d, sign * _rot(Rf, n), vw)
        return d, vw - sign * nw * (0.5 * d[..., None]), nw

    # hull 1's vertices in hull 2: hull 2's outward normal points into hull
    # 1, so the contact normal is its negation; hull 2's in hull 1: hull 1's
    # outward normal is the normal from geom1 into geom2
    a = verts_vs(p1, R1, h1[0], p2, R2, h2[1], h2[2], -1.0)
    b = verts_vs(p2, R2, h2[0], p1, R1, h1[1], h1[2], 1.0)
    return torch.cat([a[0], b[0]], dim=-1), torch.cat([a[1], b[1]], dim=-2), torch.cat([a[2], b[2]], dim=-2)


_HULL_DISPATCH = {
    (S.PLANE, S.MESH): _plane_hull,
    (S.SPHERE, S.MESH): _sphere_hull,
    (S.CYLINDER, S.MESH): _capsule_hull,
    (S.BOX, S.MESH): _box_hull,
    (S.MESH, S.MESH): _hull_hull,
}


def select_deepest(d, k):
    """Indices (.., k) of the k deepest candidates along the last dim,
    deepest first, earliest index on ties (lax.top_k(-d, k) order, and the
    CUDA narrowphase's tournament)."""
    return torch.sort(d, dim=-1, stable=True).indices[..., :k]


def _plan(model, pairs):
    """What a narrowphase of the (optionally restricted) pairs reads from the
    model, on its device, made once per model and subset: per type group
    (t1, t2, geom indices of each side, each side's sizes or hull, the
    normals' flip signs (P, 1, 1), points per pair), the buffer's per-row
    friction, solref, solimp, margin and dmask (the rows' Jacobian masks,
    anc[body2] - anc[body1]), its body1/body2 tuples, and the two tangent
    reference axes."""

    def make():
        dev, groups, rows_k, b1s, b2s = model.device, [], [], [], []
        ix = lambda v: torch.tensor(v, dtype=torch.long, device=dev)  # noqa: E731
        for (t1, t2), items in sorted(pair_groups(model, pairs).items()):
            sides = []
            for gs, t in (([it[0] for it in items], t1), ([it[1] for it in items], t2)):
                if t == S.MESH:
                    ids = ix([model.geom_meshid[g] for g in gs])
                    op = (model.mesh_verts[ids], model.mesh_fnorm[ids], model.mesh_fdist[ids])
                else:
                    op = model.geom_size[ix(gs)]
                sides.append((ix(gs), op))
            flip = torch.tensor([-1.0 if it[3] else 1.0 for it in items], dtype=model.qpos0.dtype, device=dev)
            npts = model_pair_points(model, t1, t2)
            groups.append((t1, t2, *sides[0], *sides[1], flip[:, None, None], npts))
            for _, _, k, _ in items:
                rows_k += [k] * npts
                b1s += [model.geom_bodyid[model.pair_geom1[k]]] * npts
                b2s += [model.geom_bodyid[model.pair_geom2[k]]] * npts
        k = ix(rows_k)
        rows = dict(friction=model.pair_friction[k], solref=model.pair_solref[k], solimp=model.pair_solimp[k],
                    margin=model.pair_margin[k], dmask=model.ancestor_mask[ix(b2s)] - model.ancestor_mask[ix(b1s)])
        axes = torch.eye(3, dtype=model.qpos0.dtype, device=dev)[:2]
        return groups, rows, tuple(b1s), tuple(b2s), axes

    return model.derived(("narrowphase", None if pairs is None else tuple(sorted(pairs))), make)


def narrowphase(model, kin, pairs=None):
    """Contact buffer of the (optionally restricted) candidate pairs:
    dict of dist (B, R), pos/normal/t1/t2 (B, R, 3), per-row friction,
    solref, solimp, margin (R, ...), the rows' Jacobian masks dmask
    (R, nv) and body1/body2 id tuples."""
    groups, rows, body1, body2, axes = _plan(model, pairs)
    dists, poss, nrms = [], [], []
    for t1, t2, g1, op1, g2, op2, flip, npts in groups:
        if t2 == S.MESH:
            d, p, n = _HULL_DISPATCH[(t1, t2)](kin.geom_xpos[:, g1], kin.geom_xmat[:, g1], op1,
                                               kin.geom_xpos[:, g2], kin.geom_xmat[:, g2], op2)
        else:
            def operand(g, sz):
                pos, mat = kin.geom_xpos[:, g], kin.geom_xmat[:, g]
                return (tuple(pos[..., i] for i in range(3)), [[mat[..., i, j] for j in range(3)] for i in range(3)],
                        tuple(sz[:, i] for i in range(3)))

            cands = _LANE_DISPATCH[(t1, t2)](*operand(g1, op1), *operand(g2, op2))
            d = torch.stack([c[0] for c in cands], dim=-1)                           # (B, P, n)
            bc = lambda x: torch.broadcast_to(torch.as_tensor(x, dtype=d.dtype, device=d.device), d.shape[:2])  # noqa: E731
            p = torch.stack([torch.stack([bc(x) for x in c[1]], dim=-1) for c in cands], dim=-2)  # (B, P, n, 3)
            n = torch.stack([torch.stack([bc(x) for x in c[2]], dim=-1) for c in cands], dim=-2)
        n = n * flip
        if d.shape[-1] > npts:
            idx = select_deepest(d, npts)
            d = torch.gather(d, -1, idx)
            p = torch.gather(p, -2, idx[..., None].expand(idx.shape + (3,)))
            n = torch.gather(n, -2, idx[..., None].expand(idx.shape + (3,)))
        B = d.shape[0]
        dists.append(d.reshape(B, -1))
        poss.append(p.reshape(B, -1, 3))
        nrms.append(n.reshape(B, -1, 3))

    dist = torch.cat(dists, dim=1)
    pos = torch.cat(poss, dim=1)
    n = torch.cat(nrms, dim=1)
    n = n / torch.clamp_min(torch.linalg.vector_norm(n, dim=-1, keepdim=True), 1e-9)
    ref = torch.where(torch.abs(n[..., 0:1]) < 0.5, axes[0], axes[1])
    t1v = torch.linalg.cross(n, ref)
    t1v = t1v / torch.clamp_min(torch.linalg.vector_norm(t1v, dim=-1, keepdim=True), 1e-9)
    t2v = torch.linalg.cross(n, t1v)
    return dict(dist=dist, pos=pos, normal=n, t1=t1v, t2=t2v, **rows, body1=body1, body2=body2)


def impedance(solimp, x):
    """MuJoCo constraint impedance d(x) from solimp = (d0, dmax, width,
    midpoint, power); x is the violation (>= 0)."""
    d0, dmax, width, mid, pw = (solimp[..., i] for i in range(5))
    xw = torch.clamp(x / torch.clamp_min(width, 1e-9), 0.0, 1.0)
    a = 1.0 / torch.clamp_min(mid, 1e-9) ** (pw - 1.0)
    b = 1.0 / torch.clamp_min(1.0 - mid, 1e-9) ** (pw - 1.0)
    y = torch.where(xw < mid, a * xw ** pw, 1.0 - b * (1.0 - xw) ** pw)
    return d0 + y * (dmax - d0)


def pair_min_dists(model, kin):
    """(B, npair) min narrowphase distance per candidate pair (after the
    model's manifold cut, which keeps each pair's deepest points)."""
    con = narrowphase(model, kin)
    layout = contact_row_layout(model)
    return torch.stack([con["dist"][:, layout[k]].min(dim=-1).values for k in range(model.npair)], dim=-1)


def uses_row_compaction(model) -> bool:
    """True when the model's static rows would not fit the JAX package's
    VMEM solver (nv * 3 rows > ROW_VMEM_BUDGET): its active rows then
    compact into ROW_CAP slots, and the fused substep does not take it."""
    return model.derived("row_compaction", lambda: model.nv * 3 * sum(
        len(r) for r in contact_row_layout(model).values()) > ROW_VMEM_BUDGET)


def contact_warmstart_dim(model):
    """Length of the solver's flat force vector f for this model: 3 K + ne,
    K the static rows or, on a compacting world, min(ROW_CAP, rows), and ne
    the equality rows."""
    from robosuite_tpu_torch.physics.equality import equality_row_count

    rows = sum(len(r) for r in contact_row_layout(model).values())
    return 3 * (min(ROW_CAP, rows) if uses_row_compaction(model) else rows) + equality_row_count(model)


# the row fields of the solve: per scenario (B, R, ...), then per row (R, ...)
_ROW_FIELDS = ("dist", "pos", "normal", "t1", "t2", "margin", "friction", "solref", "solimp", "dmask")
_PER_ROW = _ROW_FIELDS[5:]


def compact_rows(rows, K):
    """The first K active rows (dist < margin) of each scenario, in the
    buffer's order, by index (the JAX package's cumsum slots; rows past
    slot K - 1 drop); slots past a scenario's active count are zero.
    `rows` maps _ROW_FIELDS to their tensors; -> each (B, K, ...)."""
    act = rows["dist"] < rows["margin"]
    B = act.shape[0]
    idx = torch.argsort((~act).to(torch.int32), dim=1, stable=True)[:, :K]                # (B, K)
    keep = (torch.arange(K, device=act.device) < act.sum(dim=1, keepdim=True)).to(rows["dist"].dtype)
    out = {}
    for name, x in rows.items():
        if name in _PER_ROW:
            sel = x[idx]
        else:
            sel = torch.gather(x, 1, idx.view(B, K, *([1] * (x.dim() - 2))).expand(B, K, *x.shape[2:]))
        out[name] = sel * keep.view(B, K, *([1] * (sel.dim() - 2)))
    return out


def solver_inputs(model, kin, con, qvel, dt, eq=None):
    """Grouped-row cone-QP operands from the contact buffer and the
    equality rows eq (equality.equality_rows, or None): returns (JfT (B,
    nv, 3K + ne), aref (B, 3K + ne), reg3 (B, 3K + ne), mu (B, K), active
    (B, K)), rows ordered [normals | t1 | t2 | equality]; K the buffer's
    rows (the static layout) or, on a compacting world, min(ROW_CAP, rows).
    The ne equality rows are bilateral and always active, regularised by
    0.05 (the JAX package's contact.py)."""
    B = qvel.shape[0]
    rows = {name: con[name] for name in _ROW_FIELDS}
    if uses_row_compaction(model):
        rows = compact_rows(rows, min(ROW_CAP, rows["dist"].shape[1]))
    pos, dmask = rows["pos"], rows["dmask"]
    if dmask.dim() == 2:
        dmask = dmask.expand(B, -1, -1)
    jac_lin = kin.sdof_lin[:, None] + torch.linalg.cross(
        kin.sdof_ang[:, None].expand(-1, pos.shape[1], -1, -1), pos[:, :, None].expand(-1, -1, model.nv, -1)
    )                                                                             # (B, K, nv, 3)
    frame = torch.stack([rows["normal"], rows["t1"], rows["t2"]], dim=2)         # (B, K, 3, 3)
    J = torch.einsum("bcij,bcvj,bcv->bciv", frame, jac_lin, dmask)               # (B, K, 3, nv)

    pen = -(rows["dist"] - rows["margin"])
    active = (pen > 0.0).to(qvel.dtype)
    solref, solimp = rows["solref"], rows["solimp"]
    d = torch.clamp(impedance(solimp, pen), 1e-4, 1.0 - 1e-4)
    timeconst = torch.clamp_min(solref[..., 0], 2.0 * dt)
    dampratio = torch.clamp_min(solref[..., 1], 1e-3)
    dmax = torch.clamp(solimp[..., 1], 1e-4, 1.0 - 1e-4)
    k = d / (dmax * dmax * timeconst * timeconst * dampratio * dampratio)
    b = 2.0 / (dmax * timeconst)

    vel = (J @ qvel[:, None, :, None])[..., 0]                                   # (B, K, 3)
    reg_base = (1.0 - d) / d
    Jf = [J[:, :, 0], J[:, :, 1], J[:, :, 2]]
    aref = [-b * vel[..., 0] + k * pen, -b * vel[..., 1], -b * vel[..., 2]]
    reg3 = [reg_base, reg_base / model.impratio, reg_base / model.impratio]
    if eq is not None:
        J_eq, aref_eq = eq
        Jf.append(J_eq)
        aref.append(aref_eq)
        reg3.append(torch.full_like(aref_eq, 0.05))
    JfT = torch.cat(Jf, dim=1).transpose(1, 2)
    mu = rows["friction"][..., 0].expand(B, -1)
    return JfT.contiguous(), torch.cat(aref, dim=1), torch.cat(reg3, dim=1), mu.contiguous(), active


def contact_rows(model, kin, qvel, dt, qpos=None):
    """solver_inputs of the model's full narrowphase at kin, with its
    equality rows at (qpos, qvel) where it has any: on CPU tensors eagerly;
    on CUDA tensors by replaying a CUDA graph of the same plain code,
    captured once per model and batch size (_RowsGraph), since the
    narrowphase of a large world issues thousands of small kernels whose
    launches, not their work, take its time. Operands that carry a
    derivative run eagerly on the card too: a replay copies values only,
    so it would drop their tangents."""
    from robosuite_tpu_torch.physics.equality import equality_rows

    if model.neq and qpos is None:
        raise ValueError("a world with equality constraints needs qpos for its rows")
    fields = _RowsGraph.fields(model)
    if qvel.device.type != "cuda" or tangent.carries_derivative(qvel, qpos, *(getattr(kin, f) for f in fields)):
        eq = equality_rows(model, kin, qpos, qvel) if model.neq else None
        return solver_inputs(model, kin, narrowphase(model, kin), qvel, dt, eq)
    graph = model.derived(("rows_graph", qvel.shape[0], float(dt)), lambda: _RowsGraph(model, kin, qvel, dt, qpos))
    return graph(kin, qvel, qpos)


class _RowsGraph:
    """narrowphase + solver_inputs captured in a CUDA graph for one model,
    batch size and dt, the equality rows (equality.equality_rows) too where
    the world has any: the inputs (the geom poses, the motion subspace,
    qvel; and the body poses and qpos for the equality rows) are copied
    into static tensors, the graph replays, and the outputs are returned as
    copies (the next replay overwrites the static ones). Two eager runs on
    a side stream before the capture build the model's cached index
    tensors (_plan) and warm the allocator."""

    FIELDS = ("geom_xpos", "geom_xmat", "sdof_ang", "sdof_lin")

    @classmethod
    def fields(cls, model):
        """The KinData fields the rows read."""
        return cls.FIELDS + (("xpos", "xmat") if model.neq else ())

    def __init__(self, model, kin, qvel, dt, qpos=None):
        from robosuite_tpu_torch.physics.equality import equality_rows
        from robosuite_tpu_torch.physics.state import KinData

        self.inputs = {f: getattr(kin, f).clone() for f in self.fields(model)}
        self.qvel = qvel.clone()
        self.qpos = qpos.clone() if model.neq else None
        lite = KinData(**self.inputs, **{f: None for f in ("xpos", "xquat", "xmat", "xipos", "ximat", "site_xpos",
                                                            "site_xmat") if f not in self.inputs})

        def run():
            eq = equality_rows(model, lite, self.qpos, self.qvel) if model.neq else None
            return solver_inputs(model, lite, narrowphase(model, lite), self.qvel, dt, eq)

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                run()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.outputs = run()

    def __call__(self, kin, qvel, qpos=None):
        for f, t in self.inputs.items():
            t.copy_(getattr(kin, f))
        self.qvel.copy_(qvel)
        if self.qpos is not None:
            self.qpos.copy_(qpos)
        self.graph.replay()
        return tuple(t.clone() for t in self.outputs)
