"""One substep, one policy step and one MPPI-only solve of TwoArmHandover
(two Pandas, OSC_POSE; ToolHang's in tests/test_torch_tool_hang_step.py
and TwoArmTransport's in tests/test_torch_transport.py, over the harness
here): the port's plain
unfused path (forward products, the narrowphase, the row compaction into
96 slots, the contact solve; every robot's controller adding into one ctrl
vector) against the JAX package's on the CPU, from chip_smoke.py's contact
states (ab_kernels.handover_contact_state: robot0's pads closed on the
end of the hammer's handle; ab_kernels.tool_hang_contact_state: the pads
closed on the wrench's bar, the objects at rest on the table).

  * one substep of engine.step at B=2 under random arm torques, the
    grippers closing: qpos and qvel 1e-5;
  * one policy step of rollout_batch from the state injected into both
    (state_from_flattened), random OSC deltas: qpos, the reward and each
    robot's carried OSC goal 1e-5, qvel 1e-4;
  * one MPPI-only solve_batch (B=1, K=2, H=2, 2 knots, the planning model
    at the env's 2 ms: 2 substeps a planned step, 10 solver iterations)
    with the JAX draw injected, from the contact state injected into both:
    actions and shifted plans 1e-4.

The JAX reference runs engine.step's own parts (forward_products,
_total_smooth_force, narrowphase, _solver_inputs_impl, then the contact
solve _vel_update_xla and _integrate_qpos), vmapped over the scenarios and
jitted but for the solve, which runs eagerly: XLA:CPU compiles its
unrolled Choleskys at nv 24-36 for minutes (ToolHang's solve alone: 102 s
at -O0; its whole jitted MPPI solve 38 s to lower and 143 s to compile).
For the same reason the policy step runs at 250 Hz control (2 substeps,
both packages' envs made with control_freq=250: the goals, the substeps
and the reward of the 20 Hz step, from the 20 Hz contact state), and the
JAX MPPI solve is the JAX package's mppi_step_batch run twice, first to
read the sequences it samples, then with the returns of those sequences
rolled out through the same JAX pieces with the planning model's solver
iterations (jax_mppi_solve): the planning rollouts of the JAX env's
make_plan_return, step by step.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robosuite_tpu_torch import ab_kernels
from robosuite_tpu_torch.physics import contact as C
from robosuite_tpu_torch.physics import engine
from robosuite_tpu_torch.physics.state import State

NAMES = ("TwoArmHandover",)
MAKE = {"TwoArmHandover": dict(robots=("Panda", "Panda")), "ToolHang": dict(robots="Panda"),
        "TwoArmTransport": dict(robots=("Panda", "Panda"))}
STATE_FN = {"TwoArmHandover": ab_kernels.handover_contact_state, "ToolHang": ab_kernels.tool_hang_contact_state,
            "TwoArmTransport": ab_kernels.transport_contact_state}
MPPI = dict(horizon=2, n_samples=2, noise_sigma=0.4, temperature=0.2, n_knots=2, n_ilqr_iters=0, plan_timestep=0.05)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_pieces(jenv, jm):
    """The JAX env's step on model jm as jitted pieces, each vmapped over
    the scenarios: `substep` (engine.step's parts; the solve eager, one
    scenario at a time), `substep_with(iters, power_iters)` (the same with
    other solver iterations), `goals`, `controls`, `reward`,
    `from_flat`."""
    from robosuite_tpu.ops import pallas_contact as JPC
    from robosuite_tpu.physics import contact as JC
    from robosuite_tpu.physics import engine as JE
    from robosuite_tpu.physics.state import State as JState

    nrows = sum(len(r) for r in JC.contact_row_layout(jm).values())
    K = min(JC.ROW_CAP, nrows) if JC.uses_row_compaction(jm) else nrows
    iters = JC.APGD_ITERS if jm.solver_iters is None else jm.solver_iters
    power = JC.POWER_ITERS if jm.solver_power_iters is None else jm.solver_power_iters

    def before_solve(phys, ctrl):
        kin, M, bias = JE.forward_products(jm, phys)
        qfrc, extra = JE._total_smooth_force(jm, phys, ctrl, kin, bias, M)
        con = JC.narrowphase(jm, kin)
        return JC._solver_inputs_impl(jm, kin, con, M, phys.qvel, qfrc, jm.timestep, None,
                                      jm.dof_damping + extra)[0]

    pre = jax.jit(jax.vmap(before_solve))
    post = jax.jit(jax.vmap(lambda q, v: JE._integrate_qpos(jm, q, v, jm.timestep)))

    def substep_with(iters, power):
        def substep(phys, ctrl):
            args = pre(phys, ctrl)
            with jax.disable_jit():  # each scenario's solve unbatched and eager
                qvel = jnp.stack([JPC._vel_update_xla(*(x[b] for x in args), K, 0, iters, power, jm.timestep)[0]
                                  for b in range(phys.qpos.shape[0])])
            return JState(qpos=post(phys.qpos, qvel), qvel=qvel, time=phys.time + jm.timestep)

        return substep

    def goals(state, action):
        phys = state.physics
        kin, M, bias = JE.forward_products(jm, phys)
        cs = jenv._unpack_ctrl(state.ctrl)
        cs = [r.set_goals(kin, M, bias, phys.qpos, phys.qvel, c, a)
              for r, c, a in zip(jenv.robots, cs, jenv._split_robot_actions(jnp.clip(action, *jenv._action_clip)))]
        return jenv._pack_ctrl(cs)

    def controls(phys, packed):
        kin, M, bias = JE.forward_products(jm, phys)
        ctrl = jnp.zeros(jm.nu, dtype=phys.qpos.dtype)
        for r, c in zip(jenv.robots, jenv._unpack_ctrl(packed)):
            ctrl = r.run_controllers(kin, M, bias, phys.qpos, phys.qvel, c, ctrl)
        return ctrl

    return dict(substep=substep_with(iters, power), substep_with=substep_with, goals=jax.jit(jax.vmap(goals)),
                controls=jax.jit(jax.vmap(controls)),
                reward=jax.jit(jax.vmap(lambda phys: jenv.reward(None, phys, JE.forward_products(jm, phys)[0]))),
                from_flat=jax.jit(jax.vmap(jenv.state_from_flattened)))


def jax_policy_step(pieces, state, action, n_substeps):
    """One policy step of the JAX pieces: goals, n_substeps substeps, the
    reward at the end. -> (state', reward)."""
    packed = pieces["goals"](state, action)
    phys = state.physics
    for _ in range(n_substeps):
        phys = pieces["substep"](phys, pieces["controls"](phys, packed))
    return state.replace(physics=phys, ctrl=packed, t=state.t + 1), pieces["reward"](phys)


def jax_mppi_solve(jmpc, states, mss, plan_pieces):
    """The JAX package's MPPI-only solve of jmpc (mpc/mppi.py
    mppi_step_batch) from the states and MPC states: first run to read the
    sequences it samples (the rollouts' returns stubbed), then again with
    the returns of those sequences rolled out through plan_pieces, the
    product-carrying planning rollouts of the env's make_plan_return.
    -> the new plans (B, H, A)."""
    from robosuite_tpu.mpc import mppi as mppi_mod

    cfg = jmpc.cfg
    mcfg = mppi_mod.MPPIConfig(horizon=cfg.horizon, n_samples=cfg.n_samples, temperature=cfg.temperature,
                               noise_sigma=cfg.noise_sigma, gamma=cfg.gamma, n_knots=cfg.n_knots)
    k_noise = jax.vmap(jax.random.split)(mss.rng)[:, 1]
    seen = {}

    def read(seqs):
        seen["seqs"] = np.asarray(seqs)
        return np.zeros(seqs.shape[0], np.float32)

    def rollout(host):
        return lambda s, seq, discounts: jax.pure_callback(host, jax.ShapeDtypeStruct((), jnp.float32), seq,
                                                           vmap_method="expand_dims")

    mppi_mod.mppi_step_batch(mcfg, rollout(read), states, mss.us, k_noise)
    seqs = seen["seqs"]  # (B K, H, A) in mppi_step_batch's order
    st = jax.tree.map(lambda x: jnp.repeat(x, cfg.n_samples, axis=0), states)
    total = np.zeros(seqs.shape[0], np.float32)
    for h in range(seqs.shape[1]):
        st, r = jax_policy_step(plan_pieces, st, jnp.asarray(seqs[:, h]), jmpc.plan_substeps)
        total = total + np.asarray(r) * np.float32(cfg.gamma ** h)
    means, _ = mppi_mod.mppi_step_batch(mcfg, rollout(lambda seqs_: total), states, mss.us, k_noise)
    return means


_SETUP = {}


def setup(name):
    """(jenv, penv at 250 Hz control, flat (2, 1 + nq + nv) of the contact
    state made at 20 Hz, the JAX pieces), made once per world."""
    if name not in _SETUP:
        import robosuite_tpu
        import robosuite_tpu_torch
        from robosuite_tpu.physics import contact as JC

        kw = dict(reward_shaping=True, control_freq=250, **MAKE[name])
        jenv = robosuite_tpu.make(name, **kw)
        penv = robosuite_tpu_torch.make(name, device="cpu", **kw)
        assert jenv.n_substeps == penv.n_substeps == 2
        env20 = robosuite_tpu_torch.make(name, reward_shaping=True, device="cpu", **MAKE[name])
        s, _ = env20.reset_batch(2, torch.Generator().manual_seed(11))
        s = STATE_FN[name](env20, s)
        flat = torch.cat([s.physics.time[:, None], s.physics.qpos, s.physics.qvel], 1).numpy()
        assert C.contact_row_layout(penv.model) == JC.contact_row_layout(jenv.model)
        _SETUP[name] = jenv, penv, flat, jax_pieces(jenv, jenv.model)
    return _SETUP[name]


def hold_substep(name):
    """engine.step (K1's plain version, the narrowphase, the compaction, K2's
    plain version) from the contact state under random arm torques, the
    grippers' ctrl at their closing command: qpos and qvel 1e-5."""
    from robosuite_tpu.physics.state import State as JState

    _, penv, flat, pieces = setup(name)
    pm = penv.model
    rng = np.random.default_rng(12)
    ctrl = np.zeros((2, pm.nu), np.float32)
    for robot in penv.robots:
        ctrl[:, robot.arm_actuator_ids["right"]] = rng.uniform(-5.0, 5.0, (2, 7))
        ctrl[:, robot.gripper_actuator_ids["right"]] = [0.02, -0.02]
    q, qd = flat[:, 1:1 + pm.nq], flat[:, 1 + pm.nq:]
    out = engine.step(pm, State(qpos=torch.as_tensor(q), qvel=torch.as_tensor(qd), time=torch.zeros(2)),
                      torch.as_tensor(ctrl))
    js = pieces["substep"](JState(qpos=jnp.asarray(q), qvel=jnp.asarray(qd), time=jnp.zeros(2)), jnp.asarray(ctrl))
    np.testing.assert_allclose(out.qpos.numpy(), np.asarray(js.qpos), rtol=0, atol=1e-5)
    np.testing.assert_allclose(out.qvel.numpy(), np.asarray(js.qvel), rtol=0, atol=1e-5)


def hold_policy_step(name):
    """rollout_batch from the state injected into both, random OSC deltas
    (robot0's gripper closing): qpos, the reward and each robot's carried
    OSC goal position 1e-5, qvel 1e-4 (as tests/test_torch_twoarm_step.py:
    the pads squeezing a bar amplify the two frameworks' float32 rounding
    over the step's substeps; ToolHang's measured 5.4e-5)."""
    jenv, penv, flat, pieces = setup(name)
    rng = np.random.default_rng(13)
    a = np.clip(0.5 * rng.standard_normal((2, penv.action_dim)), -1.0, 1.0).astype(np.float32)
    a[:, penv.robots[0].action_dim - 1] = 1.0
    ps2, r = penv.rollout_batch(penv.state_from_flattened(flat), torch.as_tensor(a))
    js2, r_j = jax_policy_step(pieces, pieces["from_flat"](jnp.asarray(flat)), jnp.asarray(a), penv.n_substeps)
    np.testing.assert_allclose(ps2.physics.qpos.numpy(), np.asarray(js2.physics.qpos), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ps2.physics.qvel.numpy(), np.asarray(js2.physics.qvel), rtol=0, atol=1e-4)
    np.testing.assert_allclose(r.numpy(), np.asarray(r_j), rtol=0, atol=1e-5)
    for cs_p, cs_j in zip(penv._unpack_ctrl(ps2.ctrl), jenv._unpack_ctrl(js2.ctrl)):
        np.testing.assert_allclose(cs_p.arm["right"].goal_pos.numpy(), np.asarray(cs_j.arm["right"].goal_pos),
                                   rtol=0, atol=1e-5)
    return r


def hold_mppi_solve(name):
    """One MPPI-only solve_batch (B=1, K=2, H=2, 2 knots; the planning
    model at the 250 Hz env's dt, 2 ms, 10 solver iterations, 2 substeps a
    planned step: the unfused planning rollouts with the row compaction)
    with the JAX draw injected, from the first contact state injected into
    both: actions and shifted plans within 1e-4. -> the JAX plans."""
    from robosuite_tpu.mpc import receding as jreceding

    from robosuite_tpu_torch.mpc import receding

    jenv, penv, flat, pieces = setup(name)
    cfg = dict(MPPI, plan_timestep=0.002)
    jmpc = jreceding.RecedingMPC(jenv, jreceding.MPCConfig(**cfg))
    pmpc = receding.RecedingMPC(penv, receding.MPCConfig(**cfg))
    plan = jmpc.plan_model
    assert jmpc.plan_substeps == pmpc.plan_substeps == 2
    assert plan.timestep == jenv.model.timestep and plan.pair_points_cap is None  # the same rows as the pieces'
    js = pieces["from_flat"](jnp.asarray(flat[:1]))
    ms0 = jmpc.init_state(jax.random.PRNGKey(3))
    mss = jax.tree.map(lambda x: x[None], ms0)
    keys = jax.vmap(jax.random.split)(mss.rng)
    knots = np.array(jax.vmap(lambda key: jax.random.normal(key, (2, 2, penv.action_dim)))(keys[:, 1]))
    from robosuite_tpu.physics import contact as JC

    power = JC.POWER_ITERS if plan.solver_power_iters is None else plan.solver_power_iters
    plan_pieces = dict(pieces, substep=pieces["substep_with"](plan.solver_iters, power))
    means = np.asarray(jax_mppi_solve(jmpc, js, mss, plan_pieces))
    a_p, ms2, met = pmpc.make_solve_batch()(penv.state_from_flattened(flat[:1]), pmpc.init_state(1, None),
                                            knots=torch.as_tensor(knots))
    np.testing.assert_allclose(a_p.numpy(), means[:, 0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(ms2.us.numpy()[:, :-1], means[:, 1:], rtol=0, atol=1e-4)
    assert not bool(ms2.us[:, -1].any()) and int(met["n_masked"].sum()) == 0
    return means


@pytest.mark.parametrize("name", NAMES)
def test_substep_matches_jax(name):
    hold_substep(name)


@pytest.mark.parametrize("name", NAMES)
def test_one_policy_step_matches_jax(name):
    hold_policy_step(name)


@pytest.mark.parametrize("name", NAMES)
def test_mppi_solve_matches_jax(name):
    """The MPPI-only solve against the JAX package's (hold_mppi_solve):
    TwoArmHandover's shaped returns (robot0's reach) weigh the samples."""
    assert np.isfinite(hold_mppi_solve(name)).all()
