"""The pair kinds the PickPlace world brings and its contact rows: the
port's plain narrowphase and row compaction (physics/contact.py) against
the JAX package's on the CPU.

  * the four primitive kinds (plane-sphere, sphere-sphere, sphere-cylinder,
    which runs as sphere-capsule, and sphere-box) and the five hull kinds
    (plane-hull, sphere-hull, cylinder-hull, which runs as capsule-hull,
    box-hull and hull-hull), each on a small world of free bodies at
    random orientations, moved together until they touch 1 mm deep: every
    row's depth, point and normal 1e-5 against the JAX narrowphase;
  * a can standing upright on a plane and on a box, where many hull
    vertices tie in depth: the same rows as the JAX package's (lax.top_k
    keeps the lower index on a tie, the port's stable sort does too), and
    select_deepest against lax.top_k on data full of ties;
  * the whole narrowphase of PickPlaceCan-Sawyer (606 pairs, 1326 rows) at
    chip_smoke.py's contact state (ab_kernels.pickplace_contact_state:
    the objects resting in bin 1, the gripper closed on the can): 1e-5;
  * the row compaction: the same 96 slots in the same order as the JAX
    package's cumsum slots, with their dist, pos, normal, friction,
    solref, solimp and dmask; and the solver's operands built from them
    against the JAX _solver_inputs_impl (1e-5 of each operand's largest).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robosuite_tpu_torch import ab_kernels, convert
from robosuite_tpu_torch.models import model as PM
from robosuite_tpu_torch.models.objects.hull_objects import load_hull
from robosuite_tpu_torch.physics import contact as C
from robosuite_tpu_torch.physics import kinematics
from robosuite_tpu_torch.physics.state import KinData

KW = dict(robots="Sawyer", controller_configs="JOINT_POSITION", reward_shaping=True)
KIN_FIELDS = ("xpos", "xquat", "xmat", "xipos", "ximat", "sdof_ang", "sdof_lin",
              "geom_xpos", "geom_xmat", "site_xpos", "site_xmat")
B = 3  # scenarios of each small world


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _geom(JS, name, kind):
    """A geom of each kind the small worlds use (hulls: robosuite's can,
    milk, bread and cereal)."""
    sizes = {"sphere": (0.03,), "cylinder": (0.025, 0.04), "box": (0.04, 0.03, 0.02)}
    if kind in sizes:
        return JS.GeomSpec(name, type=kind, size=sizes[kind]), None
    return JS.GeomSpec(name, type="mesh", mesh=kind), load_hull(kind)


# (id, the plane's presence, the free bodies' geoms)
WORLDS = [
    ("plane_sphere", True, ["sphere"]),
    ("sphere_sphere", False, ["sphere", "sphere"]),
    ("sphere_cylinder", False, ["sphere", "cylinder"]),
    ("sphere_box", False, ["sphere", "box"]),
    ("plane_hull", True, ["can"]),
    ("sphere_hull", False, ["sphere", "milk"]),
    ("cylinder_hull", False, ["cylinder", "bread"]),
    ("box_hull", False, ["box", "cereal"]),
    ("hull_hull", False, ["can", "milk"]),
]


def small_world(plane, kinds):
    """(JAX model, the port's copy) of a world of free bodies with one geom
    each (and a floor plane)."""
    from robosuite_tpu.models import spec as JS

    ms = JS.ModelSpec("pairs")
    if plane:
        ms.worldbody.add_geom(JS.GeomSpec("floor", type="plane", size=(1.0, 1.0, 0.1)))
    for i, kind in enumerate(kinds):
        b = ms.worldbody.add_body(JS.BodySpec(f"b{i}"))
        b.add_joint(JS.JointSpec(f"j{i}", type="free"))
        g, hull = _geom(JS, f"g{i}", kind)
        b.add_geom(g)
        if hull is not None:
            ms.meshes[kind] = hull
    jm = ms.compile()
    pm = convert.model_from_numpy({n: np.asarray(getattr(jm, n)) for n in PM.LEAVES},
                                  {n: getattr(jm, n) for n in PM.STATIC}, device="cpu")
    return jm, pm


def _random_quats(rng, n):
    q = rng.standard_normal((n, 4))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def touching(pm, plane, n_bodies, rng, depth=1e-3):
    """(B, nq) qpos of the world's bodies at random orientations, the last
    body brought in along a random direction (straight down onto a plane)
    from 0.4 m away until the world's deepest row is first `depth` deep
    (a scan, then bisection, on the port's narrowphase)."""
    q = np.zeros((B, 7 * n_bodies), np.float32)
    for i in range(n_bodies):
        q[:, 7 * i + 3:7 * i + 7] = _random_quats(rng, B)
    d = np.tile([[0.0, 0.0, 1.0]], (B, 1)) if plane else rng.standard_normal((B, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    last = 7 * (n_bodies - 1)

    def deepest(t):
        """The deepest row at offsets t (B, n)."""
        qq = np.repeat(q[:, None], t.shape[1], axis=1)
        qq[..., last:last + 3] = t[..., None] * d[:, None]
        con = C.narrowphase(pm, kinematics.fk(pm, torch.as_tensor(qq.reshape(-1, q.shape[1]))))
        return con["dist"].min(dim=1).values.numpy().reshape(t.shape)

    grid = np.linspace(0.4, 0.0, 201, dtype=np.float32)
    for _ in range(10):
        first = np.argmax(deepest(np.tile(grid, (B, 1))) < -depth, axis=1)  # the first offset that deep
        if (first > 0).all():
            break
        # no vertex ever entered (hull-hull tests vertices against faces
        # only, so two hulls can cross edge to edge): another direction
        miss = first == 0
        d[miss] = rng.standard_normal((int(miss.sum()), 3))
        d[miss] /= np.linalg.norm(d[miss], axis=1, keepdims=True)
    assert (first > 0).all()
    lo, hi = grid[first], grid[first - 1]
    for _ in range(30):
        mid = 0.5 * (lo + hi)
        deeper = deepest(mid[:, None])[:, 0] < -depth
        lo, hi = np.where(deeper, mid, lo), np.where(deeper, hi, mid)
    q[:, last:last + 3] = lo[:, None] * d
    return q


def hold_buffer(jm, pm, qpos, tol=1e-5):
    """The port's contact buffer at qpos against the JAX narrowphase's, on
    the same (JAX) poses: every row's depth, point and normal. -> the
    port's buffer."""
    from robosuite_tpu.physics import contact as JC
    from robosuite_tpu.physics import kinematics as JK

    kins = [JK.fk(jm, jnp.asarray(q)) for q in qpos]
    kin = KinData(**{f: torch.as_tensor(np.stack([np.asarray(getattr(k, f)) for k in kins])) for f in KIN_FIELDS})
    con_p = C.narrowphase(pm, kin)
    for b, k in enumerate(kins):
        con_j = JC.narrowphase(jm, k)
        for f in ("dist", "pos", "normal"):
            np.testing.assert_allclose(con_p[f][b].numpy(), np.asarray(con_j[f]), rtol=0, atol=tol, err_msg=f)
        assert con_p["body1"] == tuple(con_j["body1"]) and con_p["body2"] == tuple(con_j["body2"])
    return con_p


@pytest.mark.parametrize("world", WORLDS, ids=[w[0] for w in WORLDS])
def test_pair_kind_touching_matches_jax(world):
    """One pair of each new kind, touching 1 mm deep at random poses (three
    scenarios): the port's rows against the JAX narrowphase's (the hull
    kinds are its vmapped _*_hull functions, the primitive ones its lane
    formulas)."""
    name, plane, kinds = world
    jm, pm = small_world(plane, kinds)
    assert pm.npair == 1 and pm.nmesh == sum(k not in ("sphere", "cylinder", "box") for k in kinds)
    qpos = touching(pm, plane, len(kinds), np.random.default_rng(sum(map(ord, name))))
    con = hold_buffer(jm, pm, qpos)
    assert float(con["dist"].min(dim=1).values.max()) < 0.0  # every scenario touches


@pytest.mark.parametrize("support", ["plane", "box"])
def test_upright_can_ties_match_jax(support):
    """The can upright (its axis along z exactly), 1 mm into a plane or
    into a box lying flat: its bottom ring's vertices tie in depth, and the
    port keeps the same four (the lowest-indexed) as the JAX package."""
    hull = load_hull("can")
    bottom = float(np.min(np.asarray(hull["verts"])[:, 2]))
    if support == "plane":
        jm, pm = small_world(True, ["can"])
        qpos = np.array([[0.1, 0.0, -bottom - 1e-3, 1.0, 0.0, 0.0, 0.0]], np.float32)
    else:
        jm, pm = small_world(False, ["box", "can"])
        qpos = np.array([[0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0,
                          0.005, -0.004, 0.02 - bottom - 1e-3, 1.0, 0.0, 0.0, 0.0]], np.float32)
    con = hold_buffer(jm, pm, qpos)
    d = con["dist"][0]
    assert torch.all(d == d[0]) and float(d[0]) < 0.0  # four tied rows, all kept at the same depth
    verts_z = np.asarray(hull["verts"])[:, 2]
    assert int(np.sum(verts_z == bottom)) > 4  # more tied vertices than rows


def test_select_deepest_matches_top_k_on_ties():
    """select_deepest (a stable sort) against lax.top_k(-d, k) on depths
    with many exact ties: the same indices in the same order."""
    rng = np.random.default_rng(3)
    d = rng.integers(0, 3, (64, 25)).astype(np.float32) * 1e-3 - 1e-3
    for k in (1, 4, 8):
        want = np.asarray(jax.lax.top_k(-jnp.asarray(d), k)[1])
        np.testing.assert_array_equal(C.select_deepest(torch.as_tensor(d), k).numpy(), want)


@pytest.fixture(scope="module")
def pick():
    """The JAX and port PickPlaceCan-Sawyer envs, the port's contact state
    (2 scenarios of ab_kernels.pickplace_contact_state) and the JAX poses
    of it, as the port's KinData and per scenario."""
    import robosuite_tpu
    import robosuite_tpu_torch
    from robosuite_tpu.physics import kinematics as JK

    jenv = robosuite_tpu.make("PickPlaceCan", **KW)
    penv = robosuite_tpu_torch.make("PickPlaceCan", device="cpu", **KW)
    s, _ = penv.reset_batch(2, torch.Generator().manual_seed(0))
    s = ab_kernels.pickplace_contact_state(penv, s)
    fk = jax.jit(lambda q: JK.fk(jenv.model, q))
    kins = [fk(jnp.asarray(q)) for q in s.physics.qpos.numpy()]
    kin = KinData(**{f: torch.as_tensor(np.stack([np.asarray(getattr(k, f)) for k in kins])) for f in KIN_FIELDS})
    return jenv, penv, s, kins, kin


@pytest.fixture(scope="module")
def buffers(pick):
    """(the port's contact buffer, the JAX one per scenario)."""
    from robosuite_tpu.physics import contact as JC

    jenv, penv, _, kins, kin = pick
    np_j = jax.jit(lambda k: JC.narrowphase(jenv.model, k))
    return C.narrowphase(penv.model, kin), [np_j(k) for k in kins]


def test_narrowphase_at_contact_state_matches_jax(pick, buffers):
    """PickPlaceCan's whole buffer (606 pairs, 1326 rows) at the contact
    state: depths, points, normals and frames 1e-5, the bodies and the
    per-row parameters; rows of the pads on the can among the active."""
    _, penv, _, _, _ = pick
    con_p, cons_j = buffers
    m = penv.model
    assert m.npair == 606 and con_p["dist"].shape[1] == 1326
    for b, con_j in enumerate(cons_j):
        for f in ("dist", "pos", "normal", "t1", "t2"):
            np.testing.assert_allclose(con_p[f][b].numpy(), np.asarray(con_j[f]), rtol=0, atol=1e-5, err_msg=f)
        assert con_p["body1"] == tuple(con_j["body1"]) and con_p["body2"] == tuple(con_j["body2"])
    for f in ("friction", "solref", "solimp", "margin"):
        np.testing.assert_allclose(con_p[f].numpy(), np.asarray(cons_j[0][f]), rtol=0, atol=1e-7, err_msg=f)
    grip = sum(penv.robot_models[0].grippers["right"].important_geoms.values(), [])
    layout = C.contact_row_layout(m)
    rows = [r for k in penv._contact_pairs(grip, penv.objects[3].contact_geoms) for r in layout[k]]
    assert bool((con_p["dist"][:, rows] < 0).any(dim=1).all())


def test_compaction_matches_jax_slots(pick, buffers):
    """The compacted rows: each scenario's active rows of the JAX buffer in
    its order (the JAX package's slot = cumsum - 1, rows past slot 95
    dropped, empty slots zero) are the port's 96 slots, with their dist,
    pos, normal, friction, solref, solimp and dmask."""
    _, penv, _, _, _ = pick
    con_p, cons_j = buffers
    m = penv.model
    assert C.uses_row_compaction(m) and C.contact_warmstart_dim(m) == 3 * C.ROW_CAP
    rows = {name: con_p[name] for name in C._ROW_FIELDS[:-1]}
    rows["dmask"] = m.ancestor_mask[list(con_p["body2"])] - m.ancestor_mask[list(con_p["body1"])]
    got = C.compact_rows(rows, C.ROW_CAP)
    anc = m.ancestor_mask.numpy()
    dmask = anc[list(con_p["body2"])] - anc[list(con_p["body1"])]
    for b, con_j in enumerate(cons_j):
        j = {k: np.asarray(v) for k, v in con_j.items() if k not in ("body1", "body2")}
        act = -(j["dist"] - j["margin"]) > 0.0
        slot = np.cumsum(act) - 1
        keep = np.flatnonzero(act & (slot < C.ROW_CAP))
        assert 4 <= len(keep) < C.ROW_CAP
        n = len(keep)
        want = dict(dist=j["dist"][keep], pos=j["pos"][keep], normal=j["normal"][keep], friction=j["friction"][keep],
                    solref=j["solref"][keep], solimp=j["solimp"][keep], dmask=dmask[keep])
        for f, w in want.items():
            np.testing.assert_allclose(got[f][b, :n].numpy(), w, rtol=0, atol=1e-5, err_msg=f)
            assert not got[f][b, n:].any(), f  # the empty slots are zero
        assert int((rows["dist"][b] < rows["margin"]).sum()) == n


def test_solver_inputs_match_jax(pick, buffers):
    """The compacted world's solver operands (JfT, aref, reg3, mu, active;
    3 x 96 rows) against the JAX _solver_inputs_impl on its own buffer:
    1e-5 of each operand's largest."""
    from robosuite_tpu.physics import contact as JC

    jenv, penv, s, kins, kin = pick
    m, jm = penv.model, jenv.model
    con_p, cons_j = buffers
    qd = s.physics.qvel
    ops_p = C.solver_inputs(m, kin, con_p, qd, m.timestep)
    assert ops_p[0].shape == (2, m.nv, 288) and ops_p[4].shape == (2, 96)
    z = jnp.zeros(jm.nv)
    bodies = dict(body1=cons_j[0]["body1"], body2=cons_j[0]["body2"])  # static row metadata
    impl = jax.jit(lambda k, c, v: JC._solver_inputs_impl(jm, k, {**c, **bodies}, jnp.eye(jm.nv), v, z, jm.timestep,
                                                          None, jm.dof_damping)[0])
    for b, (k, con_j) in enumerate(zip(kins, cons_j)):
        arrays = {f: v for f, v in con_j.items() if f not in bodies}
        args = impl(k, arrays, jnp.asarray(qd[b].numpy()))
        for name, got, want in zip(("JfT", "aref", "reg3", "mu", "active"), ops_p, (args[1], *args[2:3], *args[6:9])):
            want = np.asarray(want)
            np.testing.assert_allclose(got[b].numpy(), want, rtol=0, atol=1e-5 * max(1.0, float(np.abs(want).max())),
                                       err_msg=name)
