"""The port's batched MPC (robosuite_tpu_torch.mpc) on the CPU against the
JAX package, on the same inputs: MPPI with the JAX draw injected, the
Riccati pass, the Gauss-Newton quadratics of the Lift residual, iLQR on a
pendulum, the Lift solve_batch (MPPI only, and MPPI + 1 iLQR iteration
over both real-time-iteration branches) and the Stack (JOINT_POSITION)
MPPI-only solve_batch. The Lift states are tests/test_torch_plan.py's
resting-cube states, the Stack ones tests/test_torch_stack.py's."""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robosuite_tpu_torch import convert
from robosuite_tpu_torch.mpc import ilqr, mppi, receding
from robosuite_tpu_torch.physics import kinematics
from tests.test_torch_plan import resting_states
from tests.test_torch_door import one_thread  # noqa: F401  (an autouse fixture: one torch thread)


def _cfg(lib, **kw):
    base = dict(horizon=3, n_samples=4, noise_sigma=0.4, temperature=0.2, n_knots=2, n_ilqr_iters=0,
                plan_timestep=0.025, plan_pair_points=2)
    return lib.MPCConfig(**dict(base, **kw))


@pytest.fixture(scope="module")
def setup():
    return resting_states()


def _stack(states):
    return jax.tree.map(lambda *x: jnp.stack(x), *states)


def test_mppi_step_batch_matches_jax():
    """mppi_step_batch on a toy point mass, the JAX knots injected: new
    plans within 1e-5, metrics within 1e-5."""
    from robosuite_tpu.mpc import mppi as jmppi

    B, K, H, A, k = 3, 16, 6, 2, 3
    target = np.array([0.5, -0.3], np.float32)

    def ret_j(state, seq, disc):
        pos = state + 0.1 * jnp.cumsum(seq, axis=0)
        return jnp.sum(-jnp.sum((pos - target) ** 2, axis=-1) * disc)

    def ret_p(states, seqs, disc):
        pos = states[:, None] + 0.1 * torch.cumsum(seqs, dim=1)
        return (-((pos - torch.as_tensor(target)) ** 2).sum(-1) * disc).sum(-1)

    cfg = dict(horizon=H, n_samples=K, temperature=0.3, noise_sigma=0.5, gamma=0.9, n_knots=k)
    rng = np.random.default_rng(0)
    states = rng.normal(size=(B, A)).astype(np.float32)
    means = (0.3 * rng.normal(size=(B, H, A))).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(4), B)
    new_j, met_j = jax.jit(lambda s, m, r: jmppi.mppi_step_batch(jmppi.MPPIConfig(**cfg), ret_j, s, m, r))(
        jnp.asarray(states), jnp.asarray(means), keys)
    assert mppi.noise_shape(mppi.MPPIConfig(**cfg), A) == (K, k, A)
    knots = np.asarray(jax.vmap(lambda key: jax.random.normal(key, (K, k, A)))(keys))
    new_p, met_p = mppi.mppi_step_batch(mppi.MPPIConfig(**cfg), ret_p, torch.as_tensor(states),
                                        torch.as_tensor(means), knots=torch.as_tensor(knots))
    np.testing.assert_allclose(new_p.numpy(), np.asarray(new_j), rtol=0, atol=1e-5)
    for name in ("best_return", "mean_return", "n_masked"):
        np.testing.assert_allclose(met_p[name].numpy(), np.asarray(met_j[name]), rtol=0, atol=1e-5)


def test_backward_sequential_matches_jax():
    """The Riccati pass on a fixed random LQ problem (two solves of a
    batch, each with its own regularisation): gains and expected
    improvement within 1e-4 relative (float32 Cholesky solves of 7x7)."""
    from robosuite_tpu.mpc import ilqr as jilqr

    rng = np.random.default_rng(5)
    B, H, nx, nu = 2, 5, 6, 3

    def spd(*shape):
        a = rng.normal(size=shape + (shape[-1],))
        return a @ np.swapaxes(a, -1, -2) + np.eye(shape[-1])

    fx = np.eye(nx) + 0.1 * rng.normal(size=(B, H, nx, nx))
    fu = rng.normal(size=(B, H, nx, nu))
    cx, cu = rng.normal(size=(B, H, nx)), rng.normal(size=(B, H, nu))
    cxx, cuu = spd(B, H, nx), spd(B, H, nu)
    cux = 0.1 * rng.normal(size=(B, H, nu, nx))
    Vx, Vxx = rng.normal(size=(B, nx)), spd(B, nx)
    reg = np.array([1e-3, 0.5])
    args = [np.asarray(a, np.float32) for a in (fx, fu, cx, cu, cxx, cuu, cux, Vx, Vxx, reg)]
    ks_p, Ks_p, dv_p = ilqr.backward_sequential(*(torch.as_tensor(a) for a in args))
    bwd = jax.jit(jilqr.backward_sequential)
    for b in range(B):
        ks_j, Ks_j, dv_j = bwd(*(jnp.asarray(a[b]) for a in args))
        for p, j in ((ks_p[b], ks_j), (Ks_p[b], Ks_j), (dv_p[b], dv_j)):
            j = np.asarray(j)
            np.testing.assert_allclose(p.numpy(), j, rtol=0, atol=1e-4 * max(1.0, float(np.abs(j).max())))


@pytest.fixture(scope="module")
def harnesses(setup):
    from robosuite_tpu.mpc import receding as jreceding

    jenv, penv, _, _ = setup
    kw = dict(n_ilqr_iters=1, relin_every=2, fd_timestep=0.05)
    return (jreceding.RecedingMPC(jenv, _cfg(jreceding, **kw)), receding.RecedingMPC(penv, _cfg(receding, **kw)))


def test_gauss_newton_quadratics_of_lift_residual(harnesses, setup):
    """gauss_newton_quadratics of the Lift residual (torch.func.jacfwd over
    the plain FK, under vmap) and the terminal cost's autodiff gradient, at
    the resting-cube states with random gripper ramps and controls: within 1e-4
    relative (float32 chains of 26 rotations). The stage cost through the
    fk_pose wrapper: 1e-5 relative. (The terminal Hessian is held by the
    whole solve below.)"""
    from robosuite_tpu.mpc import ilqr as jilqr

    jmpc, pmpc = harnesses
    _, penv, flat, _ = setup
    rng = np.random.default_rng(2)
    x = np.concatenate([flat[:, 1:], rng.uniform(-1, 1, (2, 2))], axis=1).astype(np.float32)
    u = rng.uniform(-1, 1, (2, penv.action_dim)).astype(np.float32)
    t0 = torch.zeros(2, dtype=torch.long)
    q_p = ilqr.gauss_newton_quadratics(pmpc._ilqr_residual)(torch.as_tensor(x), torch.as_tensor(u), t0)
    q_j = jax.jit(jax.vmap(jilqr.gauss_newton_quadratics(jmpc._ilqr_residual), in_axes=(0, 0, None)))(
        jnp.asarray(x), jnp.asarray(u), 0)
    g_p = ilqr.autodiff_terminal_quadratics(lambda z: pmpc._ilqr_terminal(z, poses=kinematics.body_poses))(torch.as_tensor(x))[0]
    g_j = jax.jit(jax.vmap(jax.grad(jmpc._ilqr_terminal)))(jnp.asarray(x))
    for p, j in zip(tuple(q_p) + (g_p,), tuple(q_j) + (g_j,)):
        j = np.asarray(j)
        np.testing.assert_allclose(p.numpy(), j, rtol=0, atol=1e-4 * max(1.0, float(np.abs(j).max())))
    r_j = np.asarray(jax.jit(jax.vmap(jmpc._ilqr_residual, in_axes=(0, 0, None)))(jnp.asarray(x), jnp.asarray(u), 0))
    c_w = pmpc._ilqr_cost(torch.as_tensor(x), torch.as_tensor(u), t0)
    np.testing.assert_allclose(c_w.numpy(), 0.5 * (r_j * r_j).sum(-1), rtol=1e-5, atol=1e-6)


def _pendulum(lib, dt=0.05):
    """(dyn_fine, dyn_coarse, cost, terminal) of the swing-up in
    tests/test_mpc.py, written for one framework: torch on batches, JAX on
    one sample."""
    if lib is torch:
        def dyn_fine(x, u):
            for _ in range(2):
                th, om = x[:, 0], x[:, 1]
                om = om + 0.5 * dt * (u[:, 0] * 2.0 - 9.81 * torch.sin(th) - 0.1 * om)
                x = torch.stack([th + 0.5 * dt * om, om], dim=-1)
            return x

        def dyn_coarse(x, u):
            th, om = x[:, 0], x[:, 1]
            om2 = om + dt * (u[:, 0] * 2.0 - 9.81 * torch.sin(th) - 0.1 * om)
            return torch.stack([th + dt * om2, om2], dim=-1)

        def cost(x, u, t):
            return 0.1 * (u * u).sum(-1) + (torch.cos(x[:, 0]) + 1.0) ** 2 + 0.01 * x[:, 1] ** 2

        def terminal(x):
            return 10.0 * ((torch.cos(x[:, 0]) + 1.0) ** 2 + 0.1 * x[:, 1] ** 2)

        return dyn_fine, dyn_coarse, cost, terminal

    def dyn_fine(x, u):
        for _ in range(2):
            th, om = x[0], x[1]
            om = om + 0.5 * dt * (u[0] * 2.0 - 9.81 * jnp.sin(th) - 0.1 * om)
            x = jnp.stack([th + 0.5 * dt * om, om])
        return x

    def dyn_coarse(x, u):
        th, om = x
        om2 = om + dt * (u[0] * 2.0 - 9.81 * jnp.sin(th) - 0.1 * om)
        return jnp.array([th + dt * om2, om2])

    def cost(x, u, t):
        return 0.1 * jnp.sum(u ** 2) + (jnp.cos(x[0]) + 1.0) ** 2 + 0.01 * x[1] ** 2

    def terminal(x):
        return 10.0 * ((jnp.cos(x[0]) + 1.0) ** 2 + 0.1 * x[1] ** 2)

    return dyn_fine, dyn_coarse, cost, terminal


def test_ilqr_solve_pendulum_matches_jax():
    """ilqr.solve with forward differences, a coarse lin_dynamics and then
    the shifted linearization frozen (one receding tick), on two pendulum
    swing-ups of a batch: costs, plans and the linearization within 2e-3
    relative. Forward differences at eps 1e-3 turn the float32 rounding of
    the two frameworks' sin (1 ulp, ~1e-7) into ~1e-4 of fx/fu, which four
    iterations carry into the gains and plans."""
    from robosuite_tpu.mpc import ilqr as jilqr

    H = 20
    x0 = np.array([[0.1, 0.0], [-0.4, 0.3]], np.float32)
    kw = dict(horizon=H, n_iterations=4, use_fd=True, line_search_steps=6)
    fine_p, coarse_p, cost_p, term_p = _pendulum(torch)
    fine_j, coarse_j, cost_j, term_j = _pendulum(jnp)
    sol_p = ilqr.solve(ilqr.ILQRConfig(**kw), fine_p, cost_p, term_p, torch.as_tensor(x0),
                       torch.zeros(2, H, 1), lin_dynamics=coarse_p)
    solve_j = jax.jit(lambda x: jilqr.solve(jilqr.ILQRConfig(**kw), fine_j, cost_j, term_j, x, jnp.zeros((H, 1)),
                                            lin_dynamics=coarse_j))

    def close(p, j, rel=2e-3):
        j = np.asarray(j)
        np.testing.assert_allclose(p.numpy(), j, rtol=0, atol=rel * max(1.0, float(np.abs(j).max())))

    frozen_p = tuple(torch.cat([a[:, 1:], a[:, -1:]], dim=1) for a in sol_p.lin)
    us_ws = torch.cat([sol_p.us[:, 1:], sol_p.us[:, -1:]], dim=1)
    x1 = fine_p(torch.as_tensor(x0), sol_p.us[:, 0])
    rti_p = ilqr.solve(ilqr.ILQRConfig(**kw), fine_p, cost_p, term_p, x1, us_ws, frozen_lin=frozen_p)
    rti_j = jax.jit(lambda x, u, fl: jilqr.solve(jilqr.ILQRConfig(**kw), fine_j, cost_j, term_j, x, u,
                                                 frozen_lin=fl))
    for b in range(2):
        sol_j = solve_j(jnp.asarray(x0[b]))
        close(sol_p.cost[b], sol_j.cost)
        close(sol_p.us[b], sol_j.us)
        close(sol_p.lin[0][b], sol_j.lin[0])
        close(sol_p.lin[1][b], sol_j.lin[1])
        assert bool(sol_p.metrics["accepted"][-1, b]) == bool(sol_j.metrics["accepted"][-1])
        # the RTI tick, fed the port's shifted plan and linearization on both sides
        r_j = rti_j(jnp.asarray(x1[b].numpy()), jnp.asarray(us_ws[b].numpy()),
                    tuple(jnp.asarray(a[b].numpy()) for a in frozen_p))
        close(rti_p.cost[b], r_j.cost)
        close(rti_p.us[b], r_j.us)
        assert bool(rti_p.metrics["accepted"][-1, b]) == bool(r_j.metrics["accepted"][-1])


def _jax_knots(mss, shape):
    """The standard normals the JAX solve_batch draws from its MPC state."""
    keys = jax.vmap(jax.random.split)(mss.rng)
    return np.asarray(jax.vmap(lambda key: jax.random.normal(key, shape))(keys[:, 1]))


def _jax_states(jmpc, jstates, B):
    ms0 = jmpc.init_state(jax.random.PRNGKey(3))
    mss = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (B,) + x.shape), ms0)
    return _stack(jstates), mss


def test_solve_batch_mppi_only_matches_jax(setup):
    """An MPPI-only Lift solve_batch (B=2, K=4, H=3, 2 knots) with the JAX
    draw injected: actions and shifted plans within 1e-4."""
    from robosuite_tpu.mpc import receding as jreceding

    jenv, penv, flat, jstates = setup
    jmpc = jreceding.RecedingMPC(jenv, _cfg(jreceding))
    pmpc = receding.RecedingMPC(penv, _cfg(receding))
    js, mss = _jax_states(jmpc, jstates, 2)
    knots = _jax_knots(mss, (4, 2, penv.action_dim))
    a_j, mss2, _ = jax.jit(jmpc.make_solve_batch())(js, mss)
    a_p, ms2, met = pmpc.make_solve_batch()(penv.state_from_flattened(flat), pmpc.init_state(2, None),
                                            knots=torch.as_tensor(knots))
    np.testing.assert_allclose(a_p.numpy(), np.asarray(a_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ms2.us.numpy(), np.asarray(mss2.us), rtol=0, atol=1e-4)
    assert int(met["n_masked"].sum()) == 0


def test_solve_batch_mppi_only_stack_matches_jax():
    """An MPPI-only Stack solve_batch with the JOINT_POSITION arm and 8-wide
    actions (B=2, K=4, H=3, 2 knots, the full planning manifolds of the
    Stack MPC config) with the JAX draw injected: actions and shifted plans
    within 1e-4."""
    from robosuite_tpu.mpc import receding as jreceding

    from tests.test_torch_stack import resting_states as stack_resting_states

    jenv, penv, flat, jstates = stack_resting_states()
    jmpc = jreceding.RecedingMPC(jenv, _cfg(jreceding, plan_pair_points=None))
    pmpc = receding.RecedingMPC(penv, _cfg(receding, plan_pair_points=None))
    js, mss = _jax_states(jmpc, jstates, 2)
    knots = _jax_knots(mss, (4, 2, penv.action_dim))
    assert knots.shape[-1] == 8
    a_j, mss2, _ = jax.jit(jmpc.make_solve_batch())(js, mss)
    a_p, ms2, met = pmpc.make_solve_batch()(penv.state_from_flattened(flat), pmpc.init_state(2, None),
                                            knots=torch.as_tensor(knots))
    np.testing.assert_allclose(a_p.numpy(), np.asarray(a_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ms2.us.numpy(), np.asarray(mss2.us), rtol=0, atol=1e-4)
    assert int(met["n_masked"].sum()) == 0


def test_mpc_entry_points_need_a_residual_and_default_to_cuda(setup, monkeypatch):
    """RecedingMPC refuses an env with no ported residual for the iLQR
    (n_ilqr_iters > 0) unless one is passed, and builds the MPPI-only solve
    without one (the iLQR alone reads it); the MPC state is allocated on
    CUDA unless the caller asks for the CPU."""
    from robosuite_tpu_torch.mpc import residuals

    _, penv, _, _ = setup
    monkeypatch.setattr(residuals, "_RESIDUALS", {})
    with pytest.raises(NotImplementedError, match="residual"):
        receding.RecedingMPC(penv, _cfg(receding, n_ilqr_iters=1))
    assert receding.RecedingMPC(penv, _cfg(receding))._residual is None
    mpc = receding.RecedingMPC(penv, _cfg(receding), residual=residuals.lift_residual)
    assert mpc.init_state(2, None).us.device.type == "cpu"  # the env's device
    for fn in (receding.init_state, convert.mpc_state_from_numpy, convert.model_from_numpy,
               convert.state_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.slow
def test_solve_batch_with_ilqr_matches_jax(setup, harnesses):
    """The MPPI + 1 iLQR iteration Lift solve (B=2, K=4, H=3, fd_timestep
    50 ms, relin_every=2), the JAX draws injected, over two ticks from the
    same states: tick 0 runs the full forward-difference linearization,
    tick 1 the frozen (shifted) one, fed the JAX package's MPC state after
    tick 0 (convert.mpc_state_from_numpy), so both sides solve it from the
    same plans and linearization. Bounds: tick 0's actions and plans
    3e-2; its carried linearization 1e-3 relative; tick 1's actions and
    plans 1e-4. The forward differences (eps 1e-3) of the contact dynamics
    turn the two frameworks' float32 differences of one planned step (1e-5
    in qpos, 1e-4 in qvel: tests/test_torch_plan.py) into up to ~0.1 of a
    column entry (of |fx| up to ~300; measured 0.085); the Riccati gains
    carry that into tick 0's plan (measured 1.1e-2). Tick 1 has no forward
    differences (measured 1.3e-6). Marked slow: the JAX side's XLA:CPU
    compile of this solve takes 7-14 minutes."""
    jmpc, pmpc = harnesses
    jenv, penv, flat, jstates = setup
    js, mss = _jax_states(jmpc, jstates, 2)
    solve_j = jax.jit(jmpc.make_solve_batch())
    solve_p = pmpc.make_solve_batch()
    ps = penv.state_from_flattened(flat)
    ms = pmpc.init_state(2, None)
    for tick, tol in ((0, 3e-2), (1, 1e-4)):
        knots = _jax_knots(mss, (4, 2, penv.action_dim))
        if tick == 1:
            ms = convert.mpc_state_from_numpy(np.asarray(mss.us), np.asarray(mss.fxs), np.asarray(mss.fus),
                                              np.asarray(mss.tick), device="cpu")
            assert ms.tick_host == 1
        a_j, mss, met_j = solve_j(js, mss)
        a_p, ms, met_p = solve_p(ps, ms, knots=torch.as_tensor(knots))
        assert met_p["relinearized"] == (tick == 0)
        np.testing.assert_array_equal(met_p["ilqr_accepted"].numpy(), np.asarray(met_j["ilqr_accepted"]))
        np.testing.assert_allclose(met_p["ilqr_cost"].numpy(), np.asarray(met_j["ilqr_cost"]), rtol=1e-3)
        np.testing.assert_allclose(a_p.numpy(), np.asarray(a_j), rtol=0, atol=tol)
        np.testing.assert_allclose(ms.us.numpy(), np.asarray(mss.us), rtol=0, atol=tol)
        if tick == 0:
            for p, j in ((ms.fxs, mss.fxs), (ms.fus, mss.fus)):
                j = np.asarray(j)
                np.testing.assert_allclose(p.numpy(), j, rtol=0, atol=1e-3 * max(1.0, float(np.abs(j).max())))
        assert ms.tick_host == int(mss.tick[0]) == int(ms.tick[0]) == tick + 1
