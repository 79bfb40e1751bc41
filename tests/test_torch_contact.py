"""The port's contact layer (narrowphase formulas, solver rows) and K2's
plain version (ops/contact_solve.vel_update_plain) against the JAX
package on the identical world and inputs.

Narrowphase: the three Lift pair types on the same geom poses; every
candidate point and every row depth within 1e-5, the manifold cut equal
to lax.top_k's. Solver rows on the same contact buffer within 1e-5.
Velocity solve: against _vel_update_xla at a state with at least 4 active
contact rows, qvel' within 1e-5 and f within 1e-4 * max(1, max|f|)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robosuite_tpu_torch import convert
from robosuite_tpu_torch.models import model as PM
from robosuite_tpu_torch.models import spec as S
from robosuite_tpu_torch.ops import contact_solve, forward
from robosuite_tpu_torch.physics import contact as C
from robosuite_tpu_torch.physics import engine
from robosuite_tpu_torch.physics.state import KinData
from tests.test_torch_door import one_thread  # noqa: F401  (an autouse fixture: one torch thread)

CUBE = [0.021, 0.021, 0.021]
INIT = np.array([0, np.pi / 16.0, 0.00, -np.pi / 2.0 - np.pi / 3.0, 0.00, np.pi - 0.2, np.pi / 4])


def contact_states(rng, B):
    """Arm near its init pose, cube resting on the table (1.2 mm deep,
    tilted by a few mrad, any yaw) so its four bottom corners touch."""
    qpos = np.zeros((B, 16), np.float32)
    qpos[:, :7] = INIT + 0.2 * rng.standard_normal((B, 7))
    qpos[:, 7:9] = [0.02, -0.02]
    qpos[:, 9:11] = rng.uniform(-0.03, 0.03, (B, 2))
    qpos[:, 11] = 0.8 + CUBE[2] - 0.0012
    ax = rng.standard_normal((B, 3)) * np.array([0.003, 0.003, 1.0])
    ang = np.linalg.norm(ax, axis=1, keepdims=True)
    qpos[:, 12:13] = np.cos(ang / 2)
    qpos[:, 13:16] = np.sin(ang / 2) * ax / ang
    qvel = np.zeros((B, 15), np.float32)
    qvel[:, :7] = 0.1 * rng.standard_normal((B, 7))
    qvel[:, 9:15] = 0.01 * rng.standard_normal((B, 6))
    return qpos, qvel


@pytest.fixture(scope="module")
def setup():
    import robosuite_tpu

    jm = robosuite_tpu.make("Lift", robots="Panda", cube_size=CUBE, reward_shaping=True).model
    pm = convert.model_from_numpy({n: np.asarray(getattr(jm, n)) for n in PM.LEAVES},
                                  {n: getattr(jm, n) for n in PM.STATIC}, device="cpu")
    return jm, pm


@pytest.fixture(scope="module")
def jax_kin(setup):
    """JAX forward kinematics of 3 contact states, as numpy."""
    from robosuite_tpu.physics import kinematics

    jm, _ = setup
    qpos, qvel = contact_states(np.random.default_rng(0), 3)
    fk = jax.jit(lambda q: kinematics.fk(jm, q))
    kins = [fk(jnp.asarray(q)) for q in qpos]
    fields = ("xpos", "xquat", "xmat", "xipos", "ximat", "sdof_ang", "sdof_lin",
              "geom_xpos", "geom_xmat", "site_xpos", "site_xmat")
    return qpos, qvel, kins, {f: np.stack([np.asarray(getattr(k, f)) for k in kins]) for f in fields}


TYPES = [(S.PLANE, S.BOX), (S.CYLINDER, S.BOX), (S.BOX, S.BOX)]
TYPE_IDS = ["plane_box", "cylinder_box", "box_box"]


def _group(pm, types):
    return [(g1, g2) for g1, g2, _, _ in C.pair_groups(pm)[types]]


@pytest.mark.parametrize("types", TYPES, ids=TYPE_IDS)
def test_narrowphase_candidates_match_jax(setup, jax_kin, types):
    """Every candidate point of a pair type (before the manifold cut) from
    the port's formulas equals the JAX lane formulas' on the same poses."""
    from robosuite_tpu.ops.pallas_substep import _LANE_DISPATCH as JAX_LANES

    jm, pm = setup
    _, _, _, kin_np = jax_kin
    gs = _group(pm, types)
    g1s, g2s = [g[0] for g in gs], [g[1] for g in gs]

    def operand(lib, gx, gm, size, idx):
        return (tuple(lib.asarray(gx[:, idx, i]) for i in range(3)),
                [[lib.asarray(gm[:, idx, i, j]) for j in range(3)] for i in range(3)],
                tuple(lib.asarray(size[idx, i]) for i in range(3)))

    size = np.asarray(jm.geom_size)
    gx, gm = kin_np["geom_xpos"], kin_np["geom_xmat"]
    tlib = type("T", (), {"asarray": staticmethod(torch.as_tensor)})
    cands_p = C._LANE_DISPATCH[types](*operand(tlib, gx, gm, size, g1s), *operand(tlib, gx, gm, size, g2s))
    cands_j = JAX_LANES[types](*operand(jnp, gx, gm, size, g1s), *operand(jnp, gx, gm, size, g2s))
    assert len(cands_p) == len(cands_j)
    for (dp, pp, np_), (dj, pj, nj) in zip(cands_p, cands_j):
        np.testing.assert_allclose(dp.numpy(), np.broadcast_to(np.asarray(dj), dp.shape), rtol=0, atol=1e-5)
        for a, b in zip(pp + np_, pj + nj):
            a = torch.broadcast_to(torch.as_tensor(a), dp.shape).numpy()
            np.testing.assert_allclose(a, np.broadcast_to(np.asarray(b), dp.shape), rtol=0, atol=1e-5)


def test_manifold_cut_matches_top_k():
    """select_deepest keeps what lax.top_k(-d, k) keeps, exact ties
    included (deepest first, earliest index on ties)."""
    rng = np.random.default_rng(3)
    d = np.round(rng.standard_normal((64, 25)), 1).astype(np.float32)  # many exact ties
    d[:, 16:] = 1e4
    idx_p = C.select_deepest(torch.as_tensor(d), 4).numpy()
    _, idx_j = jax.lax.top_k(-jnp.asarray(d), 4)
    np.testing.assert_array_equal(idx_p, np.asarray(idx_j))


@pytest.mark.parametrize("types", TYPES, ids=TYPE_IDS)
def test_narrowphase_matches_jax(setup, jax_kin, types):
    """Whole narrowphase of a pair type: row depths and row bodies. (Which
    of two candidates within float rounding of each other is kept can
    differ between two compilations of the same formulas, so the row
    points are held by the two tests above.)"""
    from robosuite_tpu.physics import contact as JC

    jm, pm = setup
    _, _, kins, kin_np = jax_kin
    pairs = sorted(k for k in range(pm.npair)
                   if tuple(sorted((pm.geom_type[pm.pair_geom1[k]], pm.geom_type[pm.pair_geom2[k]]))) == types)
    assert pairs
    kin_p = KinData(**{f: torch.as_tensor(v) for f, v in kin_np.items()})
    con_p = C.narrowphase(pm, kin_p, pairs=set(pairs))
    np_j = jax.jit(lambda k: JC.narrowphase(jm, k, pairs=pairs))
    for b, k in enumerate(kins):
        con_j = np_j(k)
        np.testing.assert_allclose(con_p["dist"][b].numpy(), np.asarray(con_j["dist"]), rtol=0, atol=1e-5)
        assert con_p["body1"] == tuple(con_j["body1"]) and con_p["body2"] == tuple(con_j["body2"])
        for f in ("friction", "solref", "solimp", "margin"):
            np.testing.assert_allclose(con_p[f].numpy(), np.asarray(con_j[f]), rtol=0, atol=1e-7)


def test_solver_rows_and_velocity_solve_match_jax(setup, jax_kin):
    from robosuite_tpu.ops.pallas_contact import _vel_update_xla
    from robosuite_tpu.physics import contact as JC
    from robosuite_tpu.physics import dynamics as JD

    jm, pm = setup
    qpos, qvel, kins, _ = jax_kin
    q, qd = torch.as_tensor(qpos), torch.as_tensor(qvel)
    kin, M, bias = forward.forward_products(pm, q, qd)
    ctrl = torch.zeros(q.shape[0], pm.nu)
    qfrc, extra = engine.total_smooth_force(pm, q, qd, ctrl, M, bias)
    con = C.narrowphase(pm, kin)
    JfT, aref, reg3, mu, act = C.solver_inputs(pm, kin, con, qd, pm.timestep)
    assert int(act.sum(1).min()) >= 4, "the state must have at least 4 active contact rows"
    damp = pm.dof_damping + extra
    iters, piters, dt = C.APGD_ITERS, C.POWER_ITERS, pm.timestep
    qv_p, f_p = contact_solve.vel_update(M, JfT, aref, qfrc, qd, damp, reg3, mu, act, iters, piters, dt)

    K = act.shape[1]
    solve_j = jax.jit(lambda *a: _vel_update_xla(*a, K, 0, iters, piters, dt))
    static = {f: v if f in ("body1", "body2") else v.numpy()
              for f, v in con.items() if f not in ("dist", "pos", "normal", "t1", "t2")}

    def rows_fn(k, dist, pos, normal, t1, t2, M_, qv, qf, dmp):
        con_ = dict(static, dist=dist, pos=pos, normal=normal, t1=t1, t2=t2)
        return JC._solver_inputs_impl(jm, k, con_, M_, qv, qf, dt, None, dmp)[0]

    rows_j = jax.jit(rows_fn)
    for b, k in enumerate(kins):
        # the rows are built from the PORT's contact buffer on both sides,
        # so this compares the row assembly alone
        buf = [jnp.asarray(con[f][b].numpy()) for f in ("dist", "pos", "normal", "t1", "t2")]
        M_j = JD.crba(jm, k)
        args_j = rows_j(k, *buf, M_j, jnp.asarray(qvel[b]), jnp.asarray(qfrc[b].numpy()),
                        jnp.asarray(damp[b].numpy()))
        _, JfT_j, aref_j, _, _, _, reg3_j, mu_j, act_j = args_j
        np.testing.assert_allclose(JfT[b].numpy(), np.asarray(JfT_j), rtol=0, atol=1e-5)
        # aref carries k * penetration with k ~ 1e4..1e5: held relatively
        np.testing.assert_allclose(aref[b].numpy(), np.asarray(aref_j), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(reg3[b].numpy(), np.asarray(reg3_j), rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(act[b].numpy(), np.asarray(act_j))
        np.testing.assert_allclose(mu[b].numpy(), np.asarray(mu_j), rtol=0, atol=1e-7)
        # the solve itself on identical operands
        ops = [x[b].numpy() for x in (M, JfT, aref, qfrc, qd, damp, reg3, mu, act)]
        qv_j, f_j = solve_j(*(jnp.asarray(o) for o in ops))
        np.testing.assert_allclose(qv_p[b].numpy(), np.asarray(qv_j), rtol=0, atol=1e-5)
        f_tol = 1e-4 * max(1.0, float(np.abs(np.asarray(f_j)).max()))
        np.testing.assert_allclose(f_p[b].numpy(), np.asarray(f_j), rtol=0, atol=f_tol)


def test_pair_min_dists_and_engine_step_match_jax(setup, jax_kin):
    """contact.pair_min_dists and one zero-ctrl engine.step (forward
    products + narrowphase + rows + velocity solve + integration)."""
    from robosuite_tpu.physics import contact as JC
    from robosuite_tpu.physics import engine as JE
    from robosuite_tpu.physics.state import State as JState

    from robosuite_tpu_torch.physics.state import State

    jm, pm = setup
    qpos, qvel, kins, kin_np = jax_kin
    kin_p = KinData(**{f: torch.as_tensor(v) for f, v in kin_np.items()})
    pd_p = C.pair_min_dists(pm, kin_p)
    pd_j = jax.jit(lambda k: JC.pair_min_dists(jm, k))
    step_j = jax.jit(lambda q, v: JE.step(jm, JState(qpos=q, qvel=v, time=jnp.zeros(())), jnp.zeros(jm.nu)))
    B = qpos.shape[0]
    st = engine.step(pm, State(qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel), time=torch.zeros(B)),
                     torch.zeros(B, pm.nu))
    for b, k in enumerate(kins):
        np.testing.assert_allclose(pd_p[b].numpy(), np.asarray(pd_j(k)), rtol=0, atol=1e-5)
        sj = step_j(jnp.asarray(qpos[b]), jnp.asarray(qvel[b]))
        np.testing.assert_allclose(st.qpos[b].numpy(), np.asarray(sj.qpos), rtol=0, atol=1e-5)
        np.testing.assert_allclose(st.qvel[b].numpy(), np.asarray(sj.qvel), rtol=0, atol=1e-4)
