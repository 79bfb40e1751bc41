"""Contact: static pair layout, narrowphase and the solver's row assembly,
on batched tensors (the JAX package's physics/contact.py, for the pair
types of the Lift, Stack and Door worlds: plane-box, plane-cylinder,
box-box, cylinder-box and cylinder-cylinder).

The narrowphase formulas are the JAX package's lane formulas
(ops/pallas_substep.py _np_* — what its narrowphase runs for primitive
pairs): every quantity is a tuple of per-component tensors of shape
(B, P), one entry per scenario and pair of a type group. The CUDA
narrowphase (csrc/narrowphase.cuh) evaluates the same formulas.

Rows are GROUP-major: pair groups sorted by (type1, type2), pairs in model
order within a group, MANIFOLD_CAP deepest points per pair.
"""

from __future__ import annotations

import torch

from robosuite_tpu_torch.models import spec as S

APGD_ITERS = 30
POWER_ITERS = 8
MANIFOLD_CAP = 4
_BIG = 1e4

# candidate points per pair, by (type1, type2) with type1 <= type2
_PAIR_POINTS = {
    (S.PLANE, S.CYLINDER): 3,
    (S.PLANE, S.BOX): 8,
    (S.CYLINDER, S.CYLINDER): 1,
    (S.CYLINDER, S.BOX): 2,
    (S.BOX, S.BOX): 25,  # 16 two-way vertex tests + 9 SAT edge-cross rows
}


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
    n = _matcol(R1, 2)
    out = []
    for c in _CORNERS:
        pt = _add(p2, _mat_vec(R2, (c[0] * s2[0], c[1] * s2[1], c[2] * s2[2])))
        d = _dot(_sub(pt, p1), n)
        out.append((d, _sub(pt, _scale(0.5 * d, n)), n))
    return out


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


def _np_box_box(p1, R1, s1, p2, R2, s2):
    out = []
    for c in _CORNERS:  # corners of box1 vs box2
        pt = _add(p1, _mat_vec(R1, (c[0] * s1[0], c[1] * s1[1], c[2] * s1[2])))
        d, n_l = _point_box(_matT_vec(R2, _sub(pt, p2)), s2)
        nw = tuple(-x for x in _mat_vec(R2, n_l))
        out.append((d, _add(pt, _scale(0.5 * d, nw)), nw))
    for c in _CORNERS:  # corners of box2 vs box1 (normal from box1 toward box2)
        pt = _add(p2, _mat_vec(R2, (c[0] * s2[0], c[1] * s2[1], c[2] * s2[2])))
        d, n_l = _point_box(_matT_vec(R1, _sub(pt, p1)), s1)
        nw = _mat_vec(R1, n_l)
        out.append((d, _add(pt, _scale(-0.5 * d, nw)), nw))
    out.extend(_np_box_box_edges(p1, R1, s1, p2, R2, s2))
    return out


def _np_box_box_edges(p1, R1, s1, p2, R2, s2):
    """9 SAT edge-cross rows (MuJoCo mjc_BoxBox edge case), masked to +BIG
    unless the global separating axis is that edge pair's cross axis and
    it beats every face axis."""
    max_face, best_e, cands = box_box_sat(p1, R1, s1, p2, R2, s2)
    out = []
    for sep, pos, axis, valid in cands:
        emit = valid & (sep >= best_e - 1e-9) & (sep > max_face)
        out.append((torch.where(emit, sep, torch.full_like(sep, _BIG)), pos, axis))
    return out


def box_box_sat(p1, R1, s1, p2, R2, s2):
    """The separating-axis test of two boxes: (max_face, the largest face
    separation; best_e, the largest edge-cross separation; the 9 edge-cross
    candidates (sep, pos, axis, valid), sep unmasked). An edge candidate is
    emitted only where best_e beats max_face, so a near-tie of the two
    decides whether the pair's minimum distance includes an edge point."""
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

    cands, seps_e = [], []
    for i in range(3):
        for j in range(3):
            a, b = a_axes[i], b_axes[j]
            axis = _cross(a, b)
            nrm = _norm3(axis)
            valid = nrm > 1e-6
            axis = _scale(1.0 / torch.clamp_min(nrm, 1e-6), axis)
            sgn = torch.where(_dot(axis, dp) < 0.0, -torch.ones_like(nrm), torch.ones_like(nrm))
            axis = _scale(sgn, axis)
            proj1 = sum(s1[k] * torch.abs(_dot(axis, a_axes[k])) for k in range(3))
            proj2 = sum(s2[k] * torch.abs(_dot(axis, b_axes[k])) for k in range(3))
            sep = _dot(axis, dp) - proj1 - proj2
            sep = torch.where(valid, sep, torch.full_like(sep, -float("inf")))
            seps_e.append(sep)
            o1 = (0.0, 0.0, 0.0)
            o2 = (0.0, 0.0, 0.0)
            for k in range(3):
                if k != i:
                    o1 = _add(o1, _scale(torch.sign(_dot(axis, a_axes[k])) * s1[k], a_axes[k]))
                if k != j:
                    o2 = _sub(o2, _scale(torch.sign(_dot(axis, b_axes[k])) * s2[k], b_axes[k]))
            c1 = _add(p1, o1)
            c2 = _add(p2, o2)
            r = _sub(c2, c1)
            ab = _dot(a, b)
            den = torch.clamp_min(1.0 - ab * ab, 1e-9)
            t1 = torch.clamp((_dot(a, r) - ab * _dot(b, r)) / den, -s1[i], s1[i])
            t2 = torch.clamp((ab * _dot(a, r) - _dot(b, r)) / den, -s2[j], s2[j])
            q1 = _add(c1, _scale(t1, a))
            q2 = _add(c2, _scale(t2, b))
            cands.append((sep, _scale(0.5, _add(q1, q2)), axis, valid))

    best_e = seps_e[0]
    for s in seps_e[1:]:
        best_e = torch.maximum(best_e, s)
    return max_face, best_e, cands


_LANE_DISPATCH = {
    (S.PLANE, S.CYLINDER): _np_plane_cylinder,
    (S.PLANE, S.BOX): _np_plane_box,
    (S.CYLINDER, S.CYLINDER): _np_capsule_capsule,
    (S.CYLINDER, S.BOX): _np_capsule_box,
    (S.BOX, S.BOX): _np_box_box,
}


def select_deepest(d, k):
    """Indices (.., k) of the k deepest candidates along the last dim,
    deepest first, earliest index on ties (lax.top_k(-d, k) order, and the
    CUDA narrowphase's tournament)."""
    return torch.sort(d, dim=-1, stable=True).indices[..., :k]


def narrowphase(model, kin, pairs=None):
    """Contact buffer of the (optionally restricted) candidate pairs:
    dict of dist (B, R), pos/normal/t1/t2 (B, R, 3), per-row friction,
    solref, solimp, margin (R, ...) and body1/body2 id tuples."""
    dists, poss, nrms = [], [], []
    con_body1, con_body2, con_pair = [], [], []
    for (t1, t2), items in sorted(pair_groups(model, pairs).items()):
        fn = _LANE_DISPATCH[(t1, t2)]
        g1s = [it[0] for it in items]
        g2s = [it[1] for it in items]

        def operand(gs):
            pos = tuple(kin.geom_xpos[:, gs, i] for i in range(3))
            mat = [[kin.geom_xmat[:, gs, i, j] for j in range(3)] for i in range(3)]
            sz = model.geom_size[gs]
            return pos, mat, tuple(sz[:, i] for i in range(3))

        cands = fn(*operand(g1s), *operand(g2s))
        d = torch.stack([c[0] for c in cands], dim=-1)                               # (B, P, n)
        bc = lambda x: torch.broadcast_to(torch.as_tensor(x, dtype=d.dtype, device=d.device), d.shape[:2])  # noqa: E731
        p = torch.stack([torch.stack([bc(x) for x in c[1]], dim=-1) for c in cands], dim=-2)  # (B, P, n, 3)
        n = torch.stack([torch.stack([bc(x) for x in c[2]], dim=-1) for c in cands], dim=-2)
        flip = torch.tensor([-1.0 if it[3] else 1.0 for it in items], dtype=d.dtype, device=d.device)
        n = n * flip[:, None, None]
        npts = model_pair_points(model, t1, t2)
        if d.shape[-1] > npts:
            idx = select_deepest(d, npts)
            d = torch.gather(d, -1, idx)
            p = torch.gather(p, -2, idx[..., None].expand(idx.shape + (3,)))
            n = torch.gather(n, -2, idx[..., None].expand(idx.shape + (3,)))
        B = d.shape[0]
        dists.append(d.reshape(B, -1))
        poss.append(p.reshape(B, -1, 3))
        nrms.append(n.reshape(B, -1, 3))
        for _, _, k, _ in items:
            con_body1 += [model.geom_bodyid[model.pair_geom1[k]]] * npts
            con_body2 += [model.geom_bodyid[model.pair_geom2[k]]] * npts
            con_pair += [k] * npts

    dist = torch.cat(dists, dim=1)
    pos = torch.cat(poss, dim=1)
    n = torch.cat(nrms, dim=1)
    n = n / torch.clamp_min(torch.linalg.vector_norm(n, dim=-1, keepdim=True), 1e-9)
    use_ex = torch.abs(n[..., 0:1]) < 0.5
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device)
    ref = torch.where(use_ex, ex, ey)
    t1v = torch.linalg.cross(n, ref)
    t1v = t1v / torch.clamp_min(torch.linalg.vector_norm(t1v, dim=-1, keepdim=True), 1e-9)
    t2v = torch.linalg.cross(n, t1v)
    return dict(
        dist=dist, pos=pos, normal=n, t1=t1v, t2=t2v,
        friction=model.pair_friction[con_pair], solref=model.pair_solref[con_pair],
        solimp=model.pair_solimp[con_pair], margin=model.pair_margin[con_pair],
        body1=tuple(con_body1), body2=tuple(con_body2),
    )


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


def solver_inputs(model, kin, con, qvel, dt):
    """Grouped-row cone-QP operands from the contact buffer (static row
    layout): returns (JfT (B, nv, 3K), aref (B, 3K), reg3 (B, 3K),
    mu (B, K), active (B, K)), rows ordered [normals | t1 | t2]."""
    B = qvel.shape[0]
    pos = con["pos"]
    b1, b2 = list(con["body1"]), list(con["body2"])
    dmask = model.ancestor_mask[b2] - model.ancestor_mask[b1]                    # (K, nv)
    jac_lin = kin.sdof_lin[:, None] + torch.linalg.cross(
        kin.sdof_ang[:, None].expand(-1, pos.shape[1], -1, -1), pos[:, :, None].expand(-1, -1, model.nv, -1)
    )                                                                             # (B, K, nv, 3)
    frame = torch.stack([con["normal"], con["t1"], con["t2"]], dim=2)            # (B, K, 3, 3)
    J = torch.einsum("bcij,bcvj,cv->bciv", frame, jac_lin, dmask)                # (B, K, 3, nv)

    pen = -(con["dist"] - con["margin"])
    active = (pen > 0.0).to(qvel.dtype)
    solref, solimp = con["solref"], con["solimp"]
    d = torch.clamp(impedance(solimp, pen), 1e-4, 1.0 - 1e-4)
    timeconst = torch.clamp_min(solref[:, 0], 2.0 * dt)
    dampratio = torch.clamp_min(solref[:, 1], 1e-3)
    dmax = torch.clamp(solimp[:, 1], 1e-4, 1.0 - 1e-4)
    k = d / (dmax * dmax * timeconst * timeconst * dampratio * dampratio)
    b = 2.0 / (dmax * timeconst)

    vel = (J @ qvel[:, None, :, None])[..., 0]                                   # (B, K, 3)
    reg_base = (1.0 - d) / d
    JfT = torch.cat([J[:, :, 0], J[:, :, 1], J[:, :, 2]], dim=1).transpose(1, 2)
    aref = torch.cat([-b * vel[..., 0] + k * pen, -b * vel[..., 1], -b * vel[..., 2]], dim=1)
    reg3 = torch.cat([reg_base, reg_base / model.impratio, reg_base / model.impratio], dim=1)
    mu = con["friction"][:, 0].expand(B, -1)
    return JfT.contiguous(), aref, reg3, mu.contiguous(), active
