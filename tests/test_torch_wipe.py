"""The Wipe slice, Panda with the WipingGripper and the variable_kp OSC
(tools/bench_configs.py's row: 4 markers, seed 1): the port on the CPU
(its plain path) against the JAX package on the same inputs.

  * the world: every compiled leaf 1e-7, the static structure exactly
    (the pair list, the row layout, the compaction), the action width and
    bounds (the six gains in [0, 300]); the markers' names and positions
    bit for bit (the arena's random walk from the seed); the wiping
    gripper in place of the Panda's (its gripper0_ names, the eef site, no
    gripper joints or actuators); the fused gate's refusal;
  * the OSC's "variable" and "variable_kp" modes: the factory's dict form,
    the gains and the goal from set_goal and the torques of run against
    the JAX OSC on the same views (1e-5), and a Lift world's fused path
    carrying per-scenario gains (the fused substep's plain version against
    the unfused path);
  * the observations, _check_success and the step hook (the unsafe check,
    the wiped markers, the reward, the task state, done and the info keys)
    against the JAX Wipe._step_impl's own pieces, in its order, on the same
    post-step poses (1e-5): at the tool pressed on the table over the
    markers (ab_kernels.wipe_contact_state), with a marker already wiped,
    and with a joint near its limit (an unsafe step);
  * the task state through reset_batch, rollout_batch (carried unchanged;
    the reward zero, the JAX base env's) and map_state;
  * wipe_residual against the JAX one (1e-5);
  * one MPPI solve (B=2, K=2, H=2, 2 knots) with the JAX draw injected:
    actions and shifted plans within 1e-4 (the weights are uniform: the
    planning return is zero).

One substep and one policy step are held in
tests/test_torch_nut_wipe_step.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robosuite_tpu_torch import ab_kernels
from robosuite_tpu_torch.envs.base import map_state
from robosuite_tpu_torch.models import model as PM
from robosuite_tpu_torch.ops import forward, substep, tables
from robosuite_tpu_torch.physics import contact as C
from robosuite_tpu_torch.physics import kinematics


def wipe_kw(mode="variable_kp"):
    """Wipe's keywords (a fresh dict each call: the JAX factory pops the
    controller dict's "type")."""
    return dict(robots="Panda", reward_shaping=True, num_markers=4, seed=1,
                controller_configs={"right": {"type": "OSC_POSE", "impedance_mode": mode}})


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_ENVS = {}


def envs():
    """(the JAX env, the port's CPU env), made once per module."""
    if not _ENVS:
        import robosuite_tpu
        import robosuite_tpu_torch

        _ENVS["wipe"] = (robosuite_tpu.make("Wipe", **wipe_kw()), robosuite_tpu_torch.make("Wipe", device="cpu",
                                                                                          **wipe_kw()))
    return _ENVS["wipe"]


def _static(v):
    return tuple(v) if isinstance(v, (list, tuple)) else v


def test_world_matches_jax():
    """Every compiled leaf 1e-7 and every static field against the JAX
    package's; the sizes, the pairs, the row layout and compaction, the
    action bounds; the markers bit for bit; the wiping gripper swapped in."""
    from robosuite_tpu.physics import contact as JC

    jenv, penv = envs()
    jm, pm = jenv.model, penv.model
    for field in PM.LEAVES:
        a, b = np.asarray(getattr(jm, field), dtype=np.float64), getattr(pm, field).numpy().astype(np.float64)
        assert a.shape == b.shape, field
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-7, err_msg=field)
    for field in PM.STATIC:
        assert _static(getattr(pm, field)) == _static(getattr(jm, field)), field
    sizes = ("nq", "nv", "nbody", "njnt", "ngeom", "nsite", "nu", "npair")
    assert tuple(getattr(pm, n) for n in sizes) == (7, 7, 25, 7, 116, 16, 7, 175)
    assert [(pm.pair_geom1[k], pm.pair_geom2[k]) for k in range(pm.npair)] == [
        (int(jm.pair_geom1[k]), int(jm.pair_geom2[k])) for k in range(jm.npair)]
    assert C.contact_row_layout(pm) == JC.contact_row_layout(jm)
    assert sum(len(r) for r in C.contact_row_layout(pm).values()) == 448
    assert C.uses_row_compaction(pm) and JC.uses_row_compaction(jm)
    assert penv.action_dim == jenv.action_dim == 12
    lo, hi = penv.action_spec
    jlo, jhi = jenv.action_spec
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)
    assert lo.tolist() == [0.0] * 6 + [-1.0] * 6 and hi.tolist() == [300.0] * 6 + [1.0] * 6
    # the markers: the same names and positions from the same seed, bit for bit
    assert penv.arena.marker_names == jenv.arena.marker_names == [f"contact{i}" for i in range(4)]
    for n in penv.arena.marker_names:
        np.testing.assert_array_equal(penv.arena.spec.find_body(n).pos, jenv.arena.spec.find_body(n).pos)
    assert penv.marker_body_ids == jenv.marker_body_ids
    np.testing.assert_array_equal(pm.body_pos[penv.marker_body_ids].numpy(),
                                  np.asarray(jm.body_pos)[jenv.marker_body_ids])
    # the wiping gripper in place of the Panda's
    robot, jrobot = penv.robots[0], jenv.robots[0]
    assert type(penv.robot_models[0].grippers["right"]).__name__ == "WipingGripper"
    for names in ("body_names", "geom_names", "site_names", "actuator_names"):
        grip = [n for n in getattr(pm, names) if n.startswith("gripper0_")]
        assert grip == [n for n in getattr(jm, names) if n.startswith("gripper0_")], names
    assert not [n for n in pm.actuator_names if n.startswith("gripper0_")]
    assert [n for n in pm.geom_names if "finger" in n] == []
    assert robot.eef_site_id == jrobot.eef_site_id
    assert pm.site_names[robot.eef_site_id["right"]] == "gripper0_right_grip_site"
    for attr in ("gripper_joint_qpos_idx", "gripper_joint_qvel_idx", "gripper_actuator_ids"):
        assert getattr(robot, attr)["right"].tolist() == np.asarray(getattr(jrobot, attr)["right"]).tolist() == []
    assert penv._tool_table_pairs == jenv._rows_to_pairs(jenv._tool_table_rows)
    assert penv._arm_collision_pairs == jenv._rows_to_pairs(jenv._arm_collision_rows)
    assert penv.wipe_radius == jenv.wipe_radius


def test_fused_gate_refuses_the_row_compaction_and_k1_takes_the_world():
    from robosuite_tpu.ops import pallas_substep as JPS

    jenv, penv = envs()
    with pytest.raises(substep.UnsupportedFused, match="compacts"):
        substep.extract_spec(penv, penv.model)
    with pytest.raises(JPS.UnsupportedFused):
        JPS.extract_spec(jenv, jenv.model)
    assert penv._fused_for(penv.model) is None
    assert tables.check_model(penv.model, contacts=False) == 0


@pytest.mark.parametrize("mode", ["variable", "variable_kp"])
def test_osc_variable_modes_match_jax(mode):
    """The factory's dict form gives the JAX factory's config; set_goal's
    gains (clipped to their limits: kd = 2 sqrt(kp) times the clipped
    damping ratio, or 2 sqrt(kp)) and goal, and run's torques, against the
    JAX OSC on the same arm views at Wipe's reset poses (1e-5; the
    torques 1e-5 of their largest)."""
    from robosuite_tpu.controllers import factory as jfactory
    from robosuite_tpu.controllers.parts import osc as josc
    from robosuite_tpu.physics import engine as JE

    from robosuite_tpu_torch.controllers import factory
    from robosuite_tpu_torch.controllers.parts import osc

    jenv, penv = envs()
    cfg = factory.load_composite_controller_config(wipe_kw(mode)["controller_configs"], robot="Panda")["right"]
    jcfg = jfactory.load_composite_controller_config(wipe_kw(mode)["controller_configs"], robot="Panda")["right"]
    for f in ("impedance_mode", "kp_limits", "damping_ratio_limits", "kp", "damping_ratio", "control_dim"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.control_dim == {"variable": 18, "variable_kp": 12}[mode]
    s, _ = penv.reset_batch(6, torch.Generator().manual_seed(2))
    rng = np.random.default_rng(3)
    qpos = s.physics.qpos.numpy().copy()
    qpos[:, :7] += (0.2 * rng.standard_normal((6, 7))).astype(np.float32)
    qvel = (0.3 * rng.standard_normal((6, 7))).astype(np.float32)
    gains = rng.uniform(-30.0, 340.0, (6, 6)).astype(np.float32)  # some past each limit
    ratios = rng.uniform(-0.5, 12.0, (6, 6)).astype(np.float32)
    delta = rng.uniform(-1.0, 1.0, (6, 6)).astype(np.float32)
    act = np.concatenate([ratios, gains, delta] if mode == "variable" else [gains, delta], axis=1)
    jrobot, robot = jenv.robots[0], penv.robots[0]

    def jax_law(q, v, a):
        from robosuite_tpu.physics.state import State as JState

        phys = JState(qpos=q, qvel=v, time=jnp.asarray(0.0))
        kin, M, bias = JE.forward_products(jenv.model, phys)
        view = jrobot.arm_view(kin, M, bias, q, v, "right")
        st = josc.set_goal(jcfg, josc.init_state(jcfg, view), view, a)
        return st.kp, st.kd, st.goal_pos, josc.run(jcfg, st, view)

    kp_j, kd_j, gp_j, tau_j = (np.asarray(x) for x in jax.jit(jax.vmap(jax_law))(
        jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(act)))
    q, v = torch.as_tensor(qpos), torch.as_tensor(qvel)
    kin, M, bias = forward.forward_products(penv.model, q, v)
    view = robot.arm_view(kin, M, bias, q, v, "right")
    st = osc.set_goal(cfg, osc.init_state(cfg, view), view, torch.as_tensor(act))
    tau = osc.run(cfg, st, view)
    np.testing.assert_allclose(st.kp.numpy(), kp_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(st.kd.numpy(), kd_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(st.goal_pos.numpy(), gp_j, rtol=0, atol=1e-5)
    # torques of ~100 N m: 1e-5 of the largest (float32's rounding there is
    # ~1e-5 relative, and the port's operational-space inverses run in
    # float64, ROADMAP Queue 3)
    np.testing.assert_allclose(tau.numpy(), tau_j, rtol=0, atol=1e-5 * max(1.0, float(np.abs(tau_j).max())))
    assert float(st.kp.min()) == 0.0 and float(st.kp.max()) == 300.0  # clipped at both limits
    if mode == "variable":
        assert float((st.kd / (2.0 * torch.sqrt(st.kp))).nan_to_num(0.0).max()) <= 10.0 + 1e-5


def test_fused_path_carries_per_scenario_gains():
    """A fused world (Lift) with the variable_kp OSC: the fused substep's
    goal and gains rows carry each scenario's kp and kd from its action
    (envs/base._fused_goal_fn), and the fused path (on the CPU the fused
    substep's plain version) lands on the unfused path's state."""
    import robosuite_tpu_torch

    from robosuite_tpu_torch.physics import engine

    env = robosuite_tpu_torch.make("Lift", robots="Panda", reward_shaping=True, device="cpu",
                                   controller_configs=wipe_kw()["controller_configs"])
    assert env._fused_for(env.model) is not None and env.action_dim == 13
    s, _ = env.reset_batch(3, torch.Generator().manual_seed(5))
    a = torch.zeros(3, 13)
    a[:, :6] = torch.tensor([[40.0] * 6, [150.0] * 6, [290.0] * 6])
    a[:, 6:9] = 0.5
    kin, M, bias = engine.forward_products(env.model, s.physics.qpos, s.physics.qvel)
    ctrl = env._set_goals(kin, M, bias, s.physics.qpos, s.physics.qvel, s.ctrl, a)
    _, gains = env._fused_goal_fn(env.robots[0], "right", ctrl, kin)
    torch.testing.assert_close(gains[:, :6], a[:, :6])
    torch.testing.assert_close(gains[:, 6:], 2.0 * torch.sqrt(a[:, :6]))
    s1, r1 = env.rollout_batch(s, a)
    env._disable_fused = True
    try:
        s2, r2 = env.rollout_batch(s, a)
    finally:
        env._disable_fused = False
    torch.testing.assert_close(s1.physics.qpos, s2.physics.qpos, rtol=0, atol=1e-6)
    torch.testing.assert_close(r1, r2, rtol=0, atol=1e-6)
    torch.testing.assert_close(s1.ctrl.arm["right"].kp, a[:, :6])
    assert float((s1.physics.qpos[0] - s1.physics.qpos[2]).abs().max()) > 1e-4  # the gains moved the arms apart


def _jkin(kin, b):
    from robosuite_tpu.physics.state import KinData as JKin

    return JKin(**{f: jnp.asarray(v[b].numpy()) for f, v in kin.__dict__.items() if v is not None})


def _jphys(phys, b):
    from robosuite_tpu.physics.state import State as JState

    return JState(qpos=jnp.asarray(phys.qpos[b].numpy()), qvel=jnp.asarray(phys.qvel[b].numpy()),
                  time=jnp.asarray(float(phys.time[b])))


def jax_wipe_hook(jenv):
    """The JAX Wipe._step_impl after its base step (wipe.py:139-180), its
    own pieces in its order, on one scenario's post-step physics and kin,
    its previous task state and its observed eef force: -> (obs, reward,
    wiped, collisions, f_excess, unsafe | success, info), jitted."""
    def hook(phys, kin, wiped, colls, fex, force):
        colliding = jenv._any_contact(kin, jenv._arm_collision_rows)
        unsafe = colliding | jenv.robots[0].check_q_limits(phys.qpos)
        total_force = jnp.linalg.norm(force)
        w2, newly = jenv._wipe_update(kin, wiped)
        w2 = jnp.where(unsafe, wiped, w2)
        newly = newly & ~unsafe
        reward, f_over = jenv._wipe_reward(phys, kin, w2, newly, unsafe, total_force)
        colls2, fex2 = colls + unsafe.astype(jnp.int32), fex + f_over.astype(jnp.int32)
        info = dict(nwipedmarkers=jnp.sum(w2), colls=colls2, percent_viapoints_=jnp.mean(w2.astype(jnp.float32)),
                    f_excess=fex2, total_force_ee=total_force)
        return (jenv._get_observations(phys, kin), reward, w2, colls2, fex2, unsafe | jnp.all(w2), info,
                jenv._check_success(phys, kin, None))

    return jax.jit(hook)


def hold_hook(jenv, penv, prev_ts, s2, obs, r, done, info, tol):
    """The port's step_batch outputs (s2, obs, r, done, info) against
    jax_wipe_hook on the port's post-step poses, scenario by scenario."""
    hook = jax_wipe_hook(jenv)
    kin = kinematics.fk(penv.model, s2.physics.qpos)
    raw = penv._get_observations(s2.physics, kin)
    for b in range(s2.physics.qpos.shape[0]):
        o_j, r_j, w_j, c_j, f_j, end_j, info_j, ok_j = hook(
            _jphys(s2.physics, b), _jkin(kin, b), jnp.asarray(prev_ts.wiped[b].numpy()),
            jnp.asarray(int(prev_ts.collisions[b])), jnp.asarray(int(prev_ts.f_excess[b])),
            jnp.asarray(obs["robot0_eef_force"][b].numpy()))
        assert set(o_j) | {"wiped_markers"} == set(raw) | {"wiped_markers"}
        for k, v in o_j.items():
            np.testing.assert_allclose(raw[k][b].numpy(), np.asarray(v), rtol=0, atol=tol, err_msg=k)
        np.testing.assert_allclose(float(r[b]), float(r_j), rtol=0, atol=tol)
        assert s2.task_state.wiped[b].tolist() == obs["wiped_markers"][b].tolist() == np.asarray(w_j).tolist()
        assert int(s2.task_state.collisions[b]) == int(c_j) and int(s2.task_state.f_excess[b]) == int(f_j)
        assert bool(done[b]) == bool(end_j | (int(s2.t[b]) >= penv.horizon))
        for k, v in info_j.items():
            np.testing.assert_allclose(float(info[k][b]), float(v), rtol=0, atol=tol, err_msg=k)
        assert not bool(ok_j) and not bool(penv._check_success(kin)[b])
    assert set(info) == {"nwipedmarkers", "colls", "percent_viapoints_", "f_excess", "total_force_ee"}
    torch.testing.assert_close(penv._check_success(kin, s2.task_state), s2.task_state.wiped.all(dim=-1))


def test_step_hook_matches_jax_pieces():
    """One step_batch policy step from the tool pressed on the table over
    the markers (wipe_contact_state), the gains at 150 and no motion asked:
    in scenario 1 markers 0 and 1 already wiped, in scenario 3 the wrist 0.05 rad
    inside its lower limit (unsafe: the collision penalty, nothing wiped,
    done). Observations, the reward, the task state, done, the info keys
    and _check_success against the JAX pieces on the same post-step poses
    (1e-5); the eef force zero (a compacting world), so no force term
    fires."""
    jenv, penv = envs()
    s, _ = penv.reset_batch(4, torch.Generator().manual_seed(6))
    s = ab_kernels.wipe_contact_state(penv, s)
    q = s.physics.qpos.clone()
    q[3, 6] = float(penv.model.jnt_range[6, 0]) + 0.05  # the wrist's turn: the tool stays flat
    s = penv.state_from_flattened(torch.cat([s.physics.time[:, None], q, s.physics.qvel], 1))
    assert s.task_state is None
    ts = penv._reset_task_state(4)
    ts.wiped[1, :2] = True
    s = dataclasses.replace(s, task_state=ts)
    a = torch.zeros(4, penv.action_dim)
    a[:, :6] = 150.0
    s2, obs, r, done, info = penv.step_batch(s, a)
    assert not bool(obs["robot0_eef_force"].any())
    assert bool(done[3]) and float(r[3]) < 0.0 and s2.task_state.collisions.tolist() == [0, 0, 0, 1]
    assert int(s2.task_state.wiped.sum(1).max()) >= 1
    hold_hook(jenv, penv, ts, s2, obs, r, done, info, 1e-5)


def test_task_state_through_reset_rollout_and_map_state():
    """reset_batch zeroes the task state; rollout_batch carries it
    unchanged and returns the zero reward (the JAX base env's, which Wipe
    does not override); map_state indexes it; state_from_flattened has
    none, and step_batch starts one."""
    _, penv = envs()
    s, obs = penv.reset_batch(3, torch.Generator().manual_seed(7))
    assert "wiped_markers" not in obs and obs["marker_pos"].shape == (3, 4, 3)
    assert s.task_state.wiped.shape == (3, 4) and not bool(s.task_state.wiped.any())
    assert s.task_state.collisions.dtype == torch.int32 and not bool(s.task_state.collisions.any())
    ts = dataclasses.replace(s.task_state, wiped=torch.tensor([[True, False, False, False]] * 3))
    s = dataclasses.replace(s, task_state=ts)
    a = torch.zeros(3, penv.action_dim)
    s1, r = penv.rollout_batch(s, a)
    assert s1.task_state is ts and not bool(r.any())
    sub = map_state(lambda x: x[[0, 2]], s1)
    assert sub.task_state.wiped.shape == (2, 4) and bool(sub.task_state.wiped[:, 0].all())
    flat = torch.cat([s.physics.time[:, None], s.physics.qpos, s.physics.qvel], 1)
    s3, obs3, _, _, info = penv.step_batch(penv.state_from_flattened(flat), a)
    assert s3.task_state.wiped.shape == (3, 4) and obs3["wiped_markers"].shape == (3, 4)
    assert info["nwipedmarkers"].shape == (3,)


def test_residual_matches_jax():
    """wipe_residual (the tool-table pairs' narrowphase alone) against the
    JAX one at the contact state (pressing) and at random arm poses."""
    from robosuite_tpu.mpc import residuals as jres

    from robosuite_tpu_torch.mpc import residuals

    jenv, penv = envs()
    s, _ = penv.reset_batch(2, torch.Generator().manual_seed(8))
    s = ab_kernels.wipe_contact_state(penv, s)
    rng = np.random.default_rng(8)
    qpos = np.concatenate([s.physics.qpos.numpy()] * 2)
    qpos[2:] += 0.2 * rng.standard_normal((2, 7)).astype(np.float32)
    qvel = (0.1 * rng.standard_normal((4, 7))).astype(np.float32)
    u = np.zeros((4, penv.action_dim), np.float32)
    jfn = jres.residual_for(jenv)
    r_j = np.asarray(jax.jit(jax.vmap(lambda q, v, uu: jfn(jenv, jenv.model, q, v, uu)))(
        jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(u)))
    fn = residuals.residual_for(penv)
    assert fn.__name__ == jfn.__name__ == "wipe_residual"
    r_p = fn(penv, penv.model, torch.as_tensor(qpos), torch.as_tensor(qvel), torch.as_tensor(u))
    np.testing.assert_allclose(r_p.numpy(), r_j, rtol=0, atol=1e-5)
    assert bool((r_p[:2, 2] > 40.0 * (0.0005 - 0.003)).all())  # pressing about 1 mm at the contact state


def test_mppi_solve_matches_jax():
    """One MPPI-only Wipe solve_batch (B=2, K=2, H=2, 2 knots, plan dt 25
    ms; 12-wide actions, the six gains clipped to [0, 1] by the sampler and
    then to [0, 300]) with the JAX draw injected: the planning return is
    zero, so both weight the samples uniformly; actions and shifted plans
    within 1e-4."""
    from robosuite_tpu.mpc import receding as jreceding

    from robosuite_tpu_torch.mpc import receding

    jenv, penv = envs()
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
    a_j, mss2, met_j = jax.jit(jmpc.make_solve_batch())(js, mss)
    a_p, ms2, met = pmpc.make_solve_batch()(penv.state_from_flattened(flat), pmpc.init_state(2, None),
                                            knots=torch.as_tensor(knots))
    assert a_p.shape == (2, 12) and not bool(met["best_return"].any())
    np.testing.assert_allclose(a_p.numpy(), np.asarray(a_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ms2.us.numpy(), np.asarray(mss2.us), rtol=0, atol=1e-4)
    seqs = np.clip(0.4 * knots, -1.0, 1.0)
    np.testing.assert_allclose(a_p.numpy(), seqs.mean(axis=1)[:, 0], rtol=0, atol=1e-6)  # uniform weights
