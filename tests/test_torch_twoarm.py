"""The two-arm slice, TwoArmLift and TwoArmPegInHole with two Pandas and
OSC_POSE: the port on the CPU (its plain path) against the JAX package on
the same inputs.

  * each world, "opposed" and "parallel": every compiled leaf 1e-7, the
    static structure exactly (the pair list and its order among it), the
    contact row layout, the row compaction and the action width;
  * the fused substep's gate refuses both worlds for their two robots
    (UnsupportedFused, the JAX predicate), and K1's table takes them; the
    "single-robot" configuration with a one-arm robot raises;
  * the observations (every key), the reward and _check_success on the
    same poses (1e-5): TwoArmLift at a grasp of both handles
    (ab_kernels.twoarm_lift_contact_state) with the pot lifted level and
    tilted; TwoArmPegInHole at the peg's tip in the hole's mouth
    (ab_kernels.peg_contact_state) and at the peg inside the hole (the
    success branch, its pose injected into both packages' kin);
    step_batch's observations after one policy step, every robot's eef
    force and torque zero;
  * the action split, and the tuple of controller states through
    map_state: a batch indexed, and the done scenarios of a step_batch run
    replaced by fresh resets, then stepped on;
  * both planning residuals against the JAX ones (1e-5);
  * the pot's placements (the x, y and rotation ranges);
  * one MPPI solve of TwoArmPegInHole (B=2, K=2, H=2, 2 knots) with the
    JAX draw injected: actions and shifted plans within 1e-4.

One substep and one policy step of each world are held in
tests/test_torch_twoarm_step.py.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robosuite_tpu_torch import ab_kernels
from robosuite_tpu_torch.envs.base import map_state
from robosuite_tpu_torch.models import model as PM
from robosuite_tpu_torch.ops import substep, tables
from robosuite_tpu_torch.physics import contact as C
from robosuite_tpu_torch.physics import kinematics
from robosuite_tpu_torch.physics.state import KinData
from robosuite_tpu_torch.robots.robot import RobotCtrlState

KW = dict(robots=("Panda", "Panda"), reward_shaping=True)
NAMES = ("TwoArmLift", "TwoArmPegInHole")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_ENVS = {}


def envs(name, config="opposed"):
    """(the JAX env, the port's CPU env), made once per module."""
    if (name, config) not in _ENVS:
        import robosuite_tpu
        import robosuite_tpu_torch

        _ENVS[name, config] = (robosuite_tpu.make(name, env_configuration=config, **KW),
                               robosuite_tpu_torch.make(name, env_configuration=config, device="cpu", **KW))
    return _ENVS[name, config]


def _static(v):
    return tuple(v) if isinstance(v, (list, tuple)) else v


@pytest.mark.parametrize("config", ["opposed", "parallel"])
@pytest.mark.parametrize("name", NAMES)
def test_world_matches_jax(name, config):
    """Every compiled leaf 1e-7 and every static field (the pairs and their
    order among them) of each world against the JAX package's; the sizes,
    the row layout and compaction, the action width."""
    from robosuite_tpu.physics import contact as JC

    jenv, penv = envs(name, config)
    jm, pm = jenv.model, penv.model
    for field in PM.LEAVES:
        a, b = np.asarray(getattr(jm, field), dtype=np.float64), getattr(pm, field).numpy().astype(np.float64)
        assert a.shape == b.shape, field
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-7, err_msg=field)
    for field in PM.STATIC:
        assert _static(getattr(pm, field)) == _static(getattr(jm, field)), field
    sizes = ("nq", "nv", "nbody", "njnt", "ngeom", "nsite", "nu", "npair")
    want = {"TwoArmLift": (25, 24, 47, 19, 170, 19, 18, 170), "TwoArmPegInHole": (14, 14, 40, 14, 136, 19, 14, 39)}
    assert tuple(getattr(pm, n) for n in sizes) == want[name]
    assert [(pm.pair_geom1[k], pm.pair_geom2[k]) for k in range(pm.npair)] == [
        (int(jm.pair_geom1[k]), int(jm.pair_geom2[k])) for k in range(jm.npair)]
    assert C.contact_row_layout(pm) == JC.contact_row_layout(jm)
    assert C.uses_row_compaction(pm) == JC.uses_row_compaction(jm) == (name == "TwoArmLift")
    assert C.contact_warmstart_dim(pm) == JC.contact_warmstart_dim(jm)
    assert penv.action_dim == jenv.action_dim == {"TwoArmLift": 14, "TwoArmPegInHole": 12}[name]
    assert penv.eef_sites == jenv.eef_sites
    lo, hi = penv.action_spec
    jlo, jhi = jenv.action_spec
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)


@pytest.mark.parametrize("name", NAMES)
def test_fused_gate_refuses_two_robots_and_k1_takes_the_world(name):
    """The fused substep's gate refuses both worlds for their two robots
    (the JAX predicate, before the row compaction and any maximum), so
    every substep runs unfused; K1's table (no contact part) takes them."""
    from robosuite_tpu.ops import pallas_substep as JPS

    jenv, penv = envs(name)
    pm = penv.model
    with pytest.raises(substep.UnsupportedFused, match="one fixed-base robot"):
        substep.extract_spec(penv, pm)
    with pytest.raises(JPS.UnsupportedFused):
        JPS.extract_spec(jenv, jenv.model)
    assert penv._fused_for(pm) is None and penv._fused_for(pm, emit_aux=True) is None
    assert tables.check_model(pm, contacts=False) == 0
    t = tables.fill(pm)
    assert (t.nbody, t.njnt, t.ngeom, t.nsite, t.nu, t.npair) == (pm.nbody, pm.njnt, pm.ngeom, pm.nsite, pm.nu, 0)


def test_single_robot_configuration_raises():
    """One robot selects the single-robot configuration, which needs a
    bimanual robot (tests/test_torch_robots.py holds Baxter there): a
    Panda is refused with ValueError; an unknown configuration too."""
    import robosuite_tpu_torch

    for name in NAMES:
        with pytest.raises(ValueError, match="single-robot"):
            robosuite_tpu_torch.make(name, robots="Panda", device="cpu")
    with pytest.raises(ValueError, match="opposed"):
        robosuite_tpu_torch.make("TwoArmLift", env_configuration="stacked", device="cpu", **KW)


def _jkin(kin, b):
    from robosuite_tpu.physics.state import KinData as JKin

    return JKin(**{f: jnp.asarray(v[b].numpy()) for f, v in kin.__dict__.items() if v is not None})


def _jphys(phys, b):
    from robosuite_tpu.physics.state import State as JState

    return JState(qpos=jnp.asarray(phys.qpos[b].numpy()), qvel=jnp.asarray(phys.qvel[b].numpy()),
                  time=jnp.asarray(float(phys.time[b])))


_PIECES = {}


def _jax_pieces(jenv):
    """The JAX env's observations, reward and success on one scenario's
    physics state and kin, jitted."""
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
def lift_states():
    """Four TwoArmLift scenarios at a grasp of both handles; in the third
    the pot lifted 15 cm (level), in the fourth lifted and tilted 40
    degrees about x."""
    _, penv = envs("TwoArmLift")
    s, _ = penv.reset_batch(4, torch.Generator().manual_seed(1))
    s = ab_kernels.twoarm_lift_contact_state(penv, s)
    qpos = s.physics.qpos.clone()
    pot = penv.model.jnt_qpos_slice("pot_joint0").start
    qpos[2:, pot + 2] += 0.15
    h = math.radians(40.0) / 2
    q = qpos[3, pot + 3:pot + 7].clone()
    qx = torch.tensor([math.cos(h), math.sin(h), 0.0, 0.0])
    qpos[3, pot + 3:pot + 7] = torch.stack([qx[0] * q[0] - qx[1] * q[1], qx[0] * q[1] + qx[1] * q[0],
                                            qx[0] * q[2] - qx[1] * q[3], qx[0] * q[3] + qx[1] * q[2]])
    return penv.state_from_flattened(torch.cat([s.physics.time[:, None], qpos, s.physics.qvel], 1))


def test_two_arm_lift_reward_observations_success_match_jax(lift_states):
    """Observations, the shaped reward (each gripper's grasp of its handle,
    the lift term, direction_coef) and success against the JAX env's on
    the same poses; the FK poses against the JAX FK of the same qpos."""
    from robosuite_tpu.physics import kinematics as JK

    jenv, penv = envs("TwoArmLift")
    s = lift_states
    kin = kinematics.fk(penv.model, s.physics.qpos)
    jk = jax.jit(jax.vmap(lambda q: JK.fk(jenv.model, q)))(jnp.asarray(s.physics.qpos.numpy()))
    for f in ("xpos", "xmat", "site_xpos", "geom_xpos"):
        np.testing.assert_allclose(getattr(kin, f).numpy(), np.asarray(getattr(jk, f)), rtol=0, atol=1e-5, err_msg=f)
    grasps = [penv.check_grasp(kin, *pairs) for pairs in penv._grasp_pairs]
    assert bool(grasps[0][:2].all()) and bool(grasps[1][:2].all())
    r, ok = _hold_pieces(jenv, penv, s.physics, kin)
    assert ok.tolist() == [False, False, True, True]
    assert float(r[2]) == pytest.approx(1.0) and float(r[3]) == 0.0  # success level; lifted but tilted past 30 deg


def test_peg_in_hole_reward_observations_success_match_jax():
    """Observations, the shaped reward and success against the JAX env's:
    at the peg's tip in the hole's mouth (4 scenarios), and with the peg's
    pose set inside the hole along its normal (t 0.05, d 0, cos 1: the
    success branch), injected into both packages' kin."""
    jenv, penv = envs("TwoArmPegInHole")
    s, _ = penv.reset_batch(4, torch.Generator().manual_seed(2))
    s = ab_kernels.peg_contact_state(penv, s)
    kin = kinematics.fk(penv.model, s.physics.qpos)
    assert int((penv._peg_alignment(kin)[2].abs() > 0.99).sum()) >= 3  # the axis along the hole's normal
    _hold_pieces(jenv, penv, s.physics, kin)
    inside = KinData(**{f: v.clone() for f, v in kin.__dict__.items() if v is not None})
    hole, peg = penv.plate_body_id, penv.peg_body_id
    R = inside.xmat[:, hole]
    inside.xmat[:, peg] = R
    inside.xpos[:, peg] = inside.xpos[:, hole] + 0.1 * R[..., 0] - 0.05 * R[..., 2]
    r, ok = _hold_pieces(jenv, penv, s.physics, inside)
    assert bool(ok.all()) and torch.allclose(r, torch.ones(4))


@pytest.mark.parametrize("name", NAMES)
def test_step_batch_observations_match_jax(name):
    """One step_batch policy step (the plain unfused path) from a reset:
    the observations against the JAX env's at the post-step state, every
    robot's eef force and torque zero (TwoArmLift compacts its rows; the
    null grippers of TwoArmPegInHole have no geoms), a '<robot>_proprio-
    state' vector for each robot, the reward as the JAX env's."""
    jenv, penv = envs(name)
    s, obs0 = penv.reset_batch(2, torch.Generator().manual_seed(3))
    a = torch.clamp(0.5 * torch.randn(2, penv.action_dim, generator=torch.Generator().manual_seed(4)), -1, 1)
    s2, obs, r, done, _ = penv.step_batch(s, a)
    assert not bool(done.any()) and set(obs) == set(obs0) - {"placement_valid"}
    for i in range(2):
        for k in (f"robot{i}_eef_force", f"robot{i}_eef_torque"):
            assert obs[k].shape == (2, 3) and not bool(obs[k].any())
        assert obs[f"robot{i}_proprio-state"].shape[0] == 2
    kin = kinematics.fk(penv.model, s2.physics.qpos)
    raw = penv._get_observations(s2.physics, kin)
    for k, v in raw.items():
        torch.testing.assert_close(obs[k], v, rtol=0, atol=0)
    _hold_pieces(jenv, penv, s2.physics, kin)
    torch.testing.assert_close(r, penv.reward(s2.physics, kin), rtol=0, atol=0)


def test_action_split_and_the_tuple_ctrl_state_through_map_state():
    """The actions split per robot in robot order (7 + 7: OSC 6 and the
    gripper each); a batch of the tuple of controller states indexed
    through map_state; the done scenarios of a step_batch run at its
    horizon replaced by fresh resets (a two-state merge over map_state's
    order) and stepped on, matching a run of the kept scenarios alone."""
    import robosuite_tpu_torch

    penv = robosuite_tpu_torch.make("TwoArmLift", horizon=1, device="cpu", **KW)
    a = torch.arange(2 * penv.action_dim, dtype=torch.float32).reshape(2, -1)
    parts = penv._split_robot_actions(a)
    assert [p.shape[1] for p in parts] == [7, 7] and torch.equal(torch.cat(parts, 1), a)
    s, _ = penv.reset_batch(3, torch.Generator().manual_seed(5))
    assert isinstance(s.ctrl, tuple) and all(isinstance(c, RobotCtrlState) for c in s.ctrl)
    sub = map_state(lambda x: x[[0, 2]], s)
    assert isinstance(sub.ctrl, tuple) and sub.ctrl[1].arm["right"].goal_pos.shape == (2, 3)
    torch.testing.assert_close(sub.ctrl[1].gripper_action["right"], s.ctrl[1].gripper_action["right"][[0, 2]])
    act = torch.zeros(3, penv.action_dim)
    s1, _, _, done, _ = penv.step_batch(s, act)
    assert bool(done.all())
    fresh, _ = penv.reset_batch(3, torch.Generator().manual_seed(6))
    mask = torch.tensor([True, False, True])  # reset scenarios 0 and 2 only
    new = []
    map_state(lambda x: new.append(x) or x, fresh)
    it = iter(new)
    merged = map_state(lambda x: torch.where(mask.view((3,) + (1,) * (x.dim() - 1)), next(it), x), s1)
    assert isinstance(merged.ctrl, tuple) and int(merged.t.sum()) == 1
    torch.testing.assert_close(merged.ctrl[0].arm["right"].goal_pos[0], fresh.ctrl[0].arm["right"].goal_pos[0])
    torch.testing.assert_close(merged.ctrl[1].arm["right"].goal_pos[1], s1.ctrl[1].arm["right"].goal_pos[1])
    m2, _, _, _, _ = penv.step_batch(merged, act)
    alone, _, _, _, _ = penv.step_batch(map_state(lambda x: x[[1]], merged), act[[1]])
    torch.testing.assert_close(m2.physics.qpos[[1]], alone.physics.qpos, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_residuals_match_jax(name):
    """two_arm_lift_residual / two_arm_peg_in_hole_residual against the
    JAX ones at the contact states and at random arm poses, and their
    registry rows."""
    from robosuite_tpu.mpc import residuals as jres

    from robosuite_tpu_torch.mpc import residuals

    jenv, penv = envs(name)
    s, _ = penv.reset_batch(2, torch.Generator().manual_seed(7))
    state_fn = ab_kernels.twoarm_lift_contact_state if name == "TwoArmLift" else ab_kernels.peg_contact_state
    s = state_fn(penv, s)
    rng = np.random.default_rng(8)
    qpos = np.concatenate([s.physics.qpos.numpy()] * 2)
    for robot in penv.robots:
        qpos[2:, robot.arm_qpos_idx["right"]] += 0.2 * rng.standard_normal((2, 7)).astype(np.float32)
    qvel = (0.1 * rng.standard_normal((4, penv.model.nv))).astype(np.float32)
    u = np.zeros((4, penv.action_dim), np.float32)
    jfn = jres.residual_for(jenv)
    r_j = np.asarray(jax.jit(jax.vmap(lambda q, v, uu: jfn(jenv, jenv.model, q, v, uu)))(
        jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(u)))
    fn = residuals.residual_for(penv)
    assert fn.__name__ == jfn.__name__
    r_p = fn(penv, penv.model, torch.as_tensor(qpos), torch.as_tensor(qvel), torch.as_tensor(u))
    np.testing.assert_allclose(r_p.numpy(), r_j, rtol=0, atol=1e-5)


def test_pot_placements():
    """The pot's placements: x, y within +-3 cm of the table's centre, its
    bottom 1 mm above the table top, turned about z within pi +- pi/3."""
    _, penv = envs("TwoArmLift")
    n = 256
    idx, vals, valid = penv._sample_placements(torch.Generator().manual_seed(9), n)
    start = penv.model.jnt_qpos_slice("pot_joint0").start
    assert idx == list(range(start, start + 7)) and bool(valid.all())
    assert bool((vals[:, :2].abs() <= 0.03 + 1e-6).all())
    torch.testing.assert_close(vals[:, 2], torch.full((n,), 0.8 + 0.07 + 0.001), rtol=0, atol=1e-6)
    angle = 2.0 * torch.atan2(vals[:, 6], vals[:, 3])
    assert bool((angle >= math.pi - math.pi / 3 - 1e-5).all() and (angle <= math.pi + math.pi / 3 + 1e-5).all())
    assert not bool(vals[:, 4:6].any())


def test_peg_in_hole_mppi_solve_matches_jax():
    """One MPPI-only TwoArmPegInHole solve_batch (B=2, K=2, H=2, 2 knots,
    plan dt 25 ms: the unfused planning rollouts over 117 static rows)
    with the JAX draw injected, from the JAX states injected into the
    port: actions and shifted plans within 1e-4."""
    from robosuite_tpu.mpc import receding as jreceding

    from robosuite_tpu_torch.mpc import receding

    jenv, penv = envs("TwoArmPegInHole")
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
    assert pmpc.nx == jmpc.nx == penv.model.nq + penv.model.nv + 2  # each null gripper's ramp is one pad entry
    a_p, ms2, met = pmpc.make_solve_batch()(penv.state_from_flattened(flat), pmpc.init_state(2, None),
                                            knots=torch.as_tensor(knots))
    np.testing.assert_allclose(a_p.numpy(), np.asarray(a_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ms2.us.numpy(), np.asarray(mss2.us), rtol=0, atol=1e-4)
    assert int(met["n_masked"].sum()) == 0
