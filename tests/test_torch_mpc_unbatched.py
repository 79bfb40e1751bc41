"""The port's one-scenario MPC entry points on the CPU against the JAX
package's, with the JAX draws injected: mppi.mppi_step (through a
rollout_return_fn and through rollout_step), mppi_update and make_solver
on a point mass (the K samples of the scenario one batch of K); and on
Lift (tests/test_torch_plan.py's resting-cube states), the MPPI-only
RecedingMPC.make_solve; then plan_rollout_step against the planning hooks
at B=1, and make_solve with one AD-linearized iLQR iteration and the
real-time-iteration carry against solve_batch at B=1."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robosuite_tpu_torch.mpc import mppi, receding
from robosuite_tpu_torch.physics import kinematics
from tests.test_torch_door import one_thread  # noqa: F401  (an autouse fixture: one torch thread)
from tests.test_torch_plan import resting_states

TARGET = np.array([0.5, -0.3], np.float32)
CFG = dict(horizon=6, n_samples=16, temperature=0.3, noise_sigma=0.5, gamma=0.9, n_knots=3)


def _point_mass():
    """(JAX rollout_step on one state, port rollout_step on a batch, JAX and
    port rollout returns): a point mass moved by its actions toward TARGET."""
    def step_j(state, action):
        new = state + 0.1 * action
        return new, -jnp.sum((new - TARGET) ** 2)

    def step_p(states, actions):
        new = states + 0.1 * actions
        return new, -((new - torch.as_tensor(TARGET)) ** 2).sum(-1)

    def ret_j(state, seq, disc):
        pos = state + 0.1 * jnp.cumsum(seq, axis=0)
        return jnp.sum(-jnp.sum((pos - TARGET) ** 2, axis=-1) * disc)

    def ret_p(states, seqs, disc):
        pos = states[:, None] + 0.1 * torch.cumsum(seqs, dim=1)
        return (-((pos - torch.as_tensor(TARGET)) ** 2).sum(-1) * disc).sum(-1)

    return step_j, step_p, ret_j, ret_p


@pytest.mark.parametrize("through", ["rollout_return_fn", "rollout_step"])
def test_mppi_step_matches_jax(through):
    """One scenario's update with the JAX knots injected: the new plan and
    the metrics within 1e-5."""
    from robosuite_tpu.mpc import mppi as jmppi

    step_j, step_p, ret_j, ret_p = _point_mass()
    rng = np.random.default_rng(1)
    state = rng.normal(size=2).astype(np.float32)
    mean = (0.3 * rng.normal(size=(6, 2))).astype(np.float32)
    key = jax.random.PRNGKey(8)
    kw_j = dict(rollout_return_fn=ret_j) if through == "rollout_return_fn" else {}
    kw_p = dict(rollout_return_fn=ret_p) if through == "rollout_return_fn" else {}
    new_j, met_j = jax.jit(lambda s, m, k: jmppi.mppi_step(jmppi.MPPIConfig(**CFG), step_j, s, m, k, **kw_j))(
        jnp.asarray(state), jnp.asarray(mean), key)
    knots = np.asarray(jax.random.normal(key, (16, 3, 2)))
    new_p, met_p = mppi.mppi_step(mppi.MPPIConfig(**CFG), step_p, torch.as_tensor(state), torch.as_tensor(mean),
                                  knots=torch.as_tensor(knots), **kw_p)
    assert new_p.shape == (6, 2)
    np.testing.assert_allclose(new_p.numpy(), np.asarray(new_j), rtol=0, atol=1e-5)
    for name in ("best_return", "mean_return", "n_masked"):
        assert met_p[name].dim() == 0
        np.testing.assert_allclose(met_p[name].numpy(), np.asarray(met_j[name]), rtol=0, atol=1e-5)


def test_mppi_update_and_make_solver_match_jax():
    """Two receding solves of make_solver (mppi_update: the action, the plan
    shifted one step) on an env object whose policy step is the point mass
    (the JAX _rollout_impl, the port's rollout_batch), the JAX draws from
    its planner's key injected: actions and plans within 1e-5."""
    from robosuite_tpu.mpc import mppi as jmppi

    step_j, step_p, _, _ = _point_mass()

    class Env:
        _rollout_impl = staticmethod(step_j)
        rollout_batch = staticmethod(step_p)

    cfg_j, cfg_p = jmppi.MPPIConfig(**CFG), mppi.MPPIConfig(**CFG)
    solve_j = jax.jit(jmppi.make_solver(cfg_j, Env))
    solve_p = mppi.make_solver(cfg_p, Env)
    pl_j = jmppi.init_state(cfg_j, 2, jax.random.PRNGKey(2))
    pl_p = mppi.init_state(cfg_p, 2, None, device="cpu")
    assert pl_p.mean.shape == (6, 2) and not pl_p.mean.any()
    state = np.zeros(2, np.float32)
    for _ in range(2):
        knots = np.asarray(jax.random.normal(jax.random.split(pl_j.rng)[1], (16, 3, 2)))
        a_j, pl_j, _ = solve_j(jnp.asarray(state), pl_j)
        a_p, pl_p, met = solve_p(torch.as_tensor(state), pl_p, knots=torch.as_tensor(knots))
        np.testing.assert_allclose(a_p.numpy(), np.asarray(a_j), rtol=0, atol=1e-5)
        np.testing.assert_allclose(pl_p.mean.numpy(), np.asarray(pl_j.mean), rtol=0, atol=1e-5)
        assert not pl_p.mean[-1].any() and int(met["n_masked"]) == 0
        state = (state + 0.1 * a_p.numpy()).astype(np.float32)


def _cfg(lib, **kw):
    base = dict(horizon=3, n_samples=4, noise_sigma=0.4, temperature=0.2, n_knots=2, n_ilqr_iters=0,
                plan_timestep=0.025, plan_pair_points=2)
    return lib.MPCConfig(**dict(base, **kw))


@pytest.fixture(scope="module")
def lift():
    return resting_states()


def test_make_solve_matches_jax(lift):
    """One MPPI-only make_solve tick (K=4, H=3, 2 knots) of each of two
    scenarios, the JAX draw injected: the action and the shifted plan
    within 1e-4 (as solve_batch's in tests/test_torch_mpc.py)."""
    from robosuite_tpu.mpc import receding as jreceding

    jenv, penv, flat, jstates = lift
    jmpc, pmpc = jreceding.RecedingMPC(jenv, _cfg(jreceding)), receding.RecedingMPC(penv, _cfg(receding))
    solve_j = jax.jit(jmpc.make_solve())
    solve_p = pmpc.make_solve()
    ms_j = jmpc.init_state(jax.random.PRNGKey(3))
    ms_p = pmpc.init_state(None, None)
    assert ms_p.us.shape == (3, penv.action_dim)
    for b in range(2):
        ps = mppi.drop_batch(penv.state_from_flattened(flat[b:b + 1]))
        knots = np.asarray(jax.random.normal(jax.random.split(ms_j.rng)[1], (4, 2, penv.action_dim)))
        act_j, ms_j2, _ = solve_j(jstates[b], ms_j)
        act_p, ms_p2, met = solve_p(ps, ms_p, knots=torch.as_tensor(knots))
        assert act_p.shape == (penv.action_dim,) and met["best_return"].dim() == 0
        np.testing.assert_allclose(act_p.numpy(), np.asarray(act_j), rtol=0, atol=1e-4)
        np.testing.assert_allclose(ms_p2.us.numpy(), np.asarray(ms_j2.us), rtol=0, atol=1e-4)


def test_plan_rollout_step_is_the_planning_step(lift):
    """plan_rollout_step (one planned step of one scenario, no batch dim) is
    the planning model's policy step: its state make_plan_dynamics' at B=1
    and its reward the env's at that state, bit for bit (both hooks are held
    against the JAX package's in tests/test_torch_plan.py)."""
    _, penv, flat, _ = lift
    pmpc = receding.RecedingMPC(penv, _cfg(receding))
    a = torch.as_tensor(np.clip(0.5 * np.random.default_rng(3).standard_normal(penv.action_dim), -1, 1),
                        dtype=torch.float32)
    s1 = penv.state_from_flattened(flat[:1])
    s_p, r_p = pmpc.plan_rollout_step(mppi.drop_batch(s1), a)
    want = penv.make_plan_dynamics(pmpc.plan_model, pmpc.plan_substeps)(s1, a[None])
    assert s_p.physics.qpos.shape == (penv.model.nq,) and int(s_p.t) == 1 and r_p.dim() == 0
    torch.testing.assert_close(s_p.physics.qpos, want.physics.qpos[0], rtol=0, atol=0)
    torch.testing.assert_close(s_p.physics.qvel, want.physics.qvel[0], rtol=0, atol=0)
    kin = kinematics.fk(pmpc.plan_model, want.physics.qpos)
    torch.testing.assert_close(r_p, penv.reward(want.physics, kin)[0], rtol=0, atol=0)


def test_make_solve_with_ad_ilqr_is_solve_batch_at_one(lift):
    """make_solve with one iLQR iteration linearized by forward-mode AD and
    the RTI carry (relin_every=2): two ticks (a full linearization, then the
    frozen one) of one scenario equal solve_batch's at B=1 on the same knots,
    bit for bit, and carry the (H, nx, nx) linearization and the tick."""
    _, penv, flat, _ = lift
    mpc = receding.RecedingMPC(penv, _cfg(receding, horizon=2, n_ilqr_iters=1, relin_every=2, ilqr_fd=False,
                                           fd_timestep=0.05))
    solve, solve_batch = mpc.make_solve(), mpc.make_solve_batch()
    s1 = penv.state_from_flattened(flat[:1])
    s = mppi.drop_batch(s1)
    ms, ms1 = mpc.init_state(None, None), mpc.init_state(1, None)
    assert ms.fxs.shape == (2, mpc.nx, mpc.nx) and ms.tick.shape == ()
    gen = torch.Generator().manual_seed(4)
    for tick in range(2):
        knots = torch.randn(4, 2, penv.action_dim, generator=gen)
        a, ms, met = solve(s, ms, knots=knots)
        a1, ms1, met1 = solve_batch(s1, ms1, knots=knots[None])
        assert met["relinearized"] == met1["relinearized"] == (tick == 0)
        assert bool(met["ilqr_accepted"]) and bool(torch.isfinite(ms.fxs).all())
        torch.testing.assert_close(a, a1[0], rtol=0, atol=0)
        for x, x1 in ((ms.us, ms1.us), (ms.fxs, ms1.fxs), (ms.fus, ms1.fus), (ms.tick, ms1.tick)):
            torch.testing.assert_close(x, x1[0], rtol=0, atol=0)
        assert ms.tick_host == tick + 1 and int(ms.tick) == tick + 1
