"""The NutAssembly slice, Panda with OSC_POSE: the port on the CPU (its
plain path) against the JAX package on the same inputs.

  * the world of each of the four envs (NutAssembly, NutAssemblySingle,
    NutAssemblySquare, NutAssemblyRound): every compiled leaf 1e-7, the
    static structure exactly (the pair list and its order), the contact
    row layout, the row compaction, the action width and bounds; the nuts'
    free joints and their important sites;
  * the fused substep's gate refuses the world for its row compaction (the
    JAX predicate), and K1's table takes it;
  * the nuts' placements (the x, y and z ranges, the turn about z);
  * the observations (every key), the reward and _check_success on the
    same poses (1e-5), with each variant's active nut: at a grasp of the
    square nut's handle (ab_kernels.nut_contact_state) and with a nut
    set on its peg, the gripper away (the success branch); step_batch's
    observations after one policy step, the eef force zero (a compacting
    world);
  * the planning residual against the JAX one (1e-5) and its registry
    rows (the square nut for every variant, as the JAX registry has it);
  * one MPPI solve of NutAssemblySingle (B=2, K=2, H=2, 2 knots, plan dt
    25 ms) with the JAX draw injected: actions and shifted plans within
    1e-4 (the JAX solve compiles for about a minute on XLA:CPU);
  * make, without device=, builds NutAssemblySingle and Wipe on CUDA and
    raises on a machine that has none.

One substep and one policy step are held in
tests/test_torch_nut_wipe_step.py.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robosuite_tpu_torch import ab_kernels
from robosuite_tpu_torch.models import model as PM
from robosuite_tpu_torch.ops import substep, tables
from robosuite_tpu_torch.physics import contact as C
from robosuite_tpu_torch.physics import kinematics

NAMES = ("NutAssembly", "NutAssemblySingle", "NutAssemblySquare", "NutAssemblyRound")
KW = dict(robots="Panda", reward_shaping=True)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_ENVS = {}


def envs(name):
    """(the JAX env, the port's CPU env), made once per module."""
    if name not in _ENVS:
        import robosuite_tpu
        import robosuite_tpu_torch

        _ENVS[name] = (robosuite_tpu.make(name, **KW), robosuite_tpu_torch.make(name, device="cpu", **KW))
    return _ENVS[name]


def _static(v):
    return tuple(v) if isinstance(v, (list, tuple)) else v


@pytest.mark.parametrize("name", NAMES)
def test_world_matches_jax(name):
    """Every compiled leaf 1e-7 and every static field of the world against
    the JAX package's; the sizes, the pairs in order, the row layout and
    compaction, the action width and bounds, the nuts' joints and sites,
    each variant's active nut."""
    from robosuite_tpu.physics import contact as JC

    jenv, penv = envs(name)
    jm, pm = jenv.model, penv.model
    for field in PM.LEAVES:
        a, b = np.asarray(getattr(jm, field), dtype=np.float64), getattr(pm, field).numpy().astype(np.float64)
        assert a.shape == b.shape, field
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-7, err_msg=field)
    for field in PM.STATIC:
        assert _static(getattr(pm, field)) == _static(getattr(jm, field)), field
    sizes = ("nq", "nv", "nbody", "njnt", "ngeom", "nsite", "nu", "npair")
    assert tuple(getattr(pm, n) for n in sizes) == (23, 21, 31, 11, 104, 20, 9, 186)
    assert [(pm.pair_geom1[k], pm.pair_geom2[k]) for k in range(pm.npair)] == [
        (int(jm.pair_geom1[k]), int(jm.pair_geom2[k])) for k in range(jm.npair)]
    assert C.contact_row_layout(pm) == JC.contact_row_layout(jm)
    assert sum(len(r) for r in C.contact_row_layout(pm).values()) == 680
    assert C.uses_row_compaction(pm) and JC.uses_row_compaction(jm)
    assert C.contact_warmstart_dim(pm) == JC.contact_warmstart_dim(jm) == 3 * C.ROW_CAP
    assert penv.action_dim == jenv.action_dim == 7
    for a, b in zip(penv.action_spec, jenv.action_spec):
        np.testing.assert_array_equal(a, b)
    for nut_p, nut_j in zip(penv.nuts, jenv.nuts):
        assert nut_p.important_sites == nut_j.important_sites and nut_p.root_body == nut_j.root_body
        assert pm.jnt_name2id(f"{nut_p.name}_joint0") == jm.jnt_name2id(f"{nut_j.name}_joint0")
        np.testing.assert_array_equal(nut_p.bottom_offset, nut_j.bottom_offset)
        np.testing.assert_array_equal(nut_p.top_offset, nut_j.top_offset)
        assert nut_p.horizontal_radius == nut_j.horizontal_radius
        assert nut_p.contact_geoms == nut_j.contact_geoms
    assert (penv.peg1_body_id, penv.peg2_body_id, penv.nut_body_ids, penv.nut_handle_sites) == (
        jenv.peg1_body_id, jenv.peg2_body_id, jenv.nut_body_ids, jenv.nut_handle_sites)
    assert penv._active.tolist() == jenv._active_mask().tolist()
    assert [tuple(p) for p in penv._grasp_pairs_per_nut] == [
        tuple(jenv._rows_to_pairs(r) for r in rows) for rows in jenv._grasp_rows_per_nut]


def test_fused_gate_refuses_the_row_compaction_and_k1_takes_the_world():
    """The fused substep's gate refuses the world for its row compaction
    (the JAX predicate), so every substep runs unfused; K1's table takes
    the world."""
    from robosuite_tpu.ops import pallas_substep as JPS

    jenv, penv = envs("NutAssemblySingle")
    pm = penv.model
    with pytest.raises(substep.UnsupportedFused, match="compacts"):
        substep.extract_spec(penv, pm)
    with pytest.raises(JPS.UnsupportedFused):
        JPS.extract_spec(jenv, jenv.model)
    assert penv._fused_for(pm) is None and penv._fused_for(pm, emit_aux=True) is None
    assert tables.check_model(pm, contacts=False) == 0


def test_nut_placements():
    """The square nut at x in [-0.115, -0.11], y in [0.09, 0.12]; the round
    nut at y in [-0.12, -0.09]; both 3 cm above the table top (their 1 cm
    bottom offset, 2 cm z offset), turned about z over [0, 2 pi) (the
    JAX package passes no rotation range for either)."""
    _, penv = envs("NutAssembly")
    n = 512
    idx, vals, valid = penv._sample_placements(torch.Generator().manual_seed(9), n)
    starts = [penv.model.jnt_qpos_slice(f"{nut}_joint0").start for nut in ("SquareNut", "RoundNut")]
    assert idx == list(range(starts[0], starts[0] + 7)) + list(range(starts[1], starts[1] + 7)) and bool(valid.all())
    for i, (lo, hi) in enumerate(((0.09, 0.12), (-0.12, -0.09))):
        v = vals[:, 7 * i:7 * i + 7]
        assert bool(((v[:, 0] >= -0.115 - 1e-6) & (v[:, 0] <= -0.11 + 1e-6)).all())
        assert bool(((v[:, 1] >= lo - 1e-6) & (v[:, 1] <= hi + 1e-6)).all())
        torch.testing.assert_close(v[:, 2], torch.full((n,), 0.82 + 0.02 + 0.01), rtol=0, atol=1e-6)
        angle = torch.remainder(2.0 * torch.atan2(v[:, 6], v[:, 3]), 2 * math.pi)
        assert float(angle.min()) < 0.5 and float(angle.max()) > 2 * math.pi - 0.5
        assert not bool(v[:, 4:6].any())


def _jkin(kin, b):
    from robosuite_tpu.physics.state import KinData as JKin

    return JKin(**{f: jnp.asarray(v[b].numpy()) for f, v in kin.__dict__.items() if v is not None})


def _jphys(phys, b):
    from robosuite_tpu.physics.state import State as JState

    return JState(qpos=jnp.asarray(phys.qpos[b].numpy()), qvel=jnp.asarray(phys.qvel[b].numpy()),
                  time=jnp.asarray(float(phys.time[b])))


_PIECES = {}


def _jax_pieces(jenv):
    if id(jenv) not in _PIECES:
        def pieces(phys, kin):
            return jenv._get_observations(phys, kin), jenv.reward(None, phys, kin), jenv._check_success(phys, kin)

        _PIECES[id(jenv)] = jax.jit(pieces)
    return _PIECES[id(jenv)]


def _hold_pieces(jenv, penv, phys, kin):
    obs = penv._get_observations(phys, kin)
    r = penv.reward(phys, kin)
    ok = penv._check_success(kin)
    for b in range(phys.qpos.shape[0]):
        obs_j, r_j, ok_j = _jax_pieces(jenv)(_jphys(phys, b), _jkin(kin, b))
        assert set(obs_j) == set(obs)
        for k, v in obs_j.items():
            np.testing.assert_allclose(obs[k][b].numpy(), np.asarray(v), rtol=0, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(float(r[b]), float(r_j), rtol=0, atol=1e-5)
        assert bool(ok[b]) == bool(ok_j)
    return r, ok


@pytest.fixture(scope="module")
def nut_states():
    """Four NutAssemblySingle scenarios at a grasp of the square nut's
    handle (nut_contact_state); in the third the square nut set on peg1 and
    in the fourth the round nut on peg2, the arm as the reset put it."""
    _, penv = envs("NutAssemblySingle")
    s, _ = penv.reset_batch(4, torch.Generator().manual_seed(1))
    reset_q = s.physics.qpos.clone()
    s = ab_kernels.nut_contact_state(penv, s)
    qpos = s.physics.qpos.clone()
    m = penv.model
    for b, (nut, peg) in ((2, ("SquareNut", "peg1")), (3, ("RoundNut", "peg2"))):
        a = m.jnt_qpos_slice(f"{nut}_joint0").start
        qpos[b] = reset_q[b]
        peg_pos = m.body_pos[m.body_name2id(peg)]
        qpos[b, a:a + 3] = torch.stack([peg_pos[0] + 0.01, peg_pos[1] - 0.01, torch.tensor(0.83)])
    return penv.state_from_flattened(torch.cat([s.physics.time[:, None], qpos, torch.zeros_like(s.physics.qvel)], 1))


@pytest.mark.parametrize("name", ["NutAssemblySingle", "NutAssembly", "NutAssemblyRound"])
def test_reward_observations_success_match_jax(nut_states, name):
    """Observations, the shaped reward (reach, grasp, lift, hover over the
    active nuts; one per nut on its peg) and success against the JAX env's
    on the same poses; the square nut grasped in the first two scenarios."""
    jenv, penv = envs(name)
    s = nut_states
    kin = kinematics.fk(penv.model, s.physics.qpos)
    grasps = [penv.check_grasp(kin, *pairs) for pairs in penv._grasp_pairs_per_nut]
    assert bool(grasps[0][:2].all()) and not bool(grasps[1].any())
    r, ok = _hold_pieces(jenv, penv, s.physics, kin)
    on = penv._objects_on_pegs(kin)
    assert on.tolist() == [[False, False], [False, False], [True, False], [False, True]]
    want = {"NutAssemblySingle": [False, False, True, False], "NutAssembly": [False] * 4,
            "NutAssemblyRound": [False, False, False, True]}[name]
    assert ok.tolist() == want


def test_step_batch_observations_match_jax():
    """One step_batch policy step (the plain unfused path) from a reset:
    the observations against the JAX env's at the post-step state, the eef
    force and torque zero (a compacting world, as in the JAX package), the
    proprio and object modalities, the reward as the JAX env's."""
    jenv, penv = envs("NutAssemblySingle")
    s, obs0 = penv.reset_batch(2, torch.Generator().manual_seed(3))
    a = torch.clamp(0.5 * torch.randn(2, penv.action_dim, generator=torch.Generator().manual_seed(4)), -1, 1)
    s2, obs, r, done, info = penv.step_batch(s, a)
    assert not bool(done.any()) and info == {} and set(obs) == set(obs0) - {"placement_valid"}
    assert bool(obs0["placement_valid"].all())
    for k in ("robot0_eef_force", "robot0_eef_torque"):
        assert obs[k].shape == (2, 3) and not bool(obs[k].any())
    assert obs["robot0_proprio-state"].shape == (2, 45) and obs["object-state"].shape == (2, 20)
    kin = kinematics.fk(penv.model, s2.physics.qpos)
    raw = penv._get_observations(s2.physics, kin)
    for k, v in raw.items():
        torch.testing.assert_close(obs[k], v, rtol=0, atol=0)
    _hold_pieces(jenv, penv, s2.physics, kin)
    torch.testing.assert_close(r, penv.reward(s2.physics, kin), rtol=0, atol=0)


def test_residual_matches_jax(nut_states):
    """nut_assembly_residual against the JAX one at the contact states and
    at random arm poses; every NutAssembly registry row is it, reaching for
    the square nut."""
    from robosuite_tpu.mpc import residuals as jres

    from robosuite_tpu_torch.mpc import residuals

    jenv, penv = envs("NutAssemblySingle")
    rng = np.random.default_rng(8)
    qpos = np.concatenate([nut_states.physics.qpos.numpy()] * 2)
    qpos[4:, penv.robots[0].arm_qpos_idx["right"]] += 0.2 * rng.standard_normal((4, 7)).astype(np.float32)
    qvel = (0.1 * rng.standard_normal((8, penv.model.nv))).astype(np.float32)
    u = np.zeros((8, penv.action_dim), np.float32)
    jfn = jres.residual_for(jenv)
    r_j = np.asarray(jax.jit(jax.vmap(lambda q, v, uu: jfn(jenv, jenv.model, q, v, uu)))(
        jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(u)))
    fn = residuals.residual_for(penv)
    assert fn.__name__ == jfn.__name__ == "nut_assembly_residual"
    r_p = fn(penv, penv.model, torch.as_tensor(qpos), torch.as_tensor(qvel), torch.as_tensor(u))
    np.testing.assert_allclose(r_p.numpy(), r_j, rtol=0, atol=1e-5)
    for name in NAMES:
        assert residuals._RESIDUALS[name] is fn


def test_mppi_solve_matches_jax():
    """One MPPI-only NutAssemblySingle solve_batch (B=2, K=2, H=2, 2 knots,
    plan dt 25 ms: the unfused planning rollouts with the row compaction)
    with the JAX draw injected, from the JAX states injected into the port:
    actions and shifted plans within 1e-4."""
    from robosuite_tpu.mpc import receding as jreceding

    from robosuite_tpu_torch.mpc import receding

    jenv, penv = envs("NutAssemblySingle")
    cfg = dict(horizon=2, n_samples=2, noise_sigma=0.4, temperature=0.2, n_knots=2, n_ilqr_iters=0,
               plan_timestep=0.025)
    jmpc = jreceding.RecedingMPC(jenv, jreceding.MPCConfig(**cfg))
    pmpc = receding.RecedingMPC(penv, receding.MPCConfig(**cfg))
    s, _ = penv.reset_batch(2, torch.Generator().manual_seed(10))
    flat = torch.cat([s.physics.time[:, None], s.physics.qpos, s.physics.qvel], 1).numpy()
    js = jax.jit(jax.vmap(jenv.state_from_flattened))(jnp.asarray(flat))
    ms0 = jmpc.init_state(jax.random.PRNGKey(3))
    mss = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (2,) + x.shape), ms0)
    keys = jax.vmap(jax.random.split)(mss.rng)
    knots = np.asarray(jax.vmap(lambda key: jax.random.normal(key, (2, 2, penv.action_dim)))(keys[:, 1]))
    a_j, mss2, _ = jax.jit(jmpc.make_solve_batch())(js, mss)
    a_p, ms2, met = pmpc.make_solve_batch()(penv.state_from_flattened(flat), pmpc.init_state(2, None),
                                            knots=torch.as_tensor(knots))
    np.testing.assert_allclose(a_p.numpy(), np.asarray(a_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ms2.us.numpy(), np.asarray(mss2.us), rtol=0, atol=1e-4)
    assert int(met["n_masked"].sum()) == 0


@pytest.mark.parametrize("name", ["NutAssemblySingle", "Wipe"])
def test_make_runs_on_cuda_unless_asked_for_the_cpu(name, monkeypatch):
    """Without device= the envs run on CUDA, and make raises on a machine
    that has none."""
    import robosuite_tpu_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        robosuite_tpu_torch.make(name, robots="Panda")
