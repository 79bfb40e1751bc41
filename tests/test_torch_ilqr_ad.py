"""The port's iLQR with the AD linearization (use_fd=False: forward mode
with use_jacfwd, reverse mode without) and the associative Riccati pass
(parallel_backward), on the CPU against the JAX package's ilqr: the
pendulum of tests/test_torch_mpc.py, the random nonlinear problem of the
JAX package's tests/test_mpc.py (test_parallel_backward_matches_sequential)
as a batch of two solves, and random LQ data for backward_associative."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robosuite_tpu_torch.mpc import ilqr
from tests.test_torch_door import one_thread  # noqa: F401  (an autouse fixture: one torch thread)
from tests.test_torch_mpc import _pendulum


def _close(p, j, rel):
    j = np.asarray(j)
    np.testing.assert_allclose(np.asarray(p), j, rtol=0, atol=rel * max(1.0, float(np.abs(j).max())))


@pytest.mark.parametrize("use_jacfwd", [True, False], ids=["jacfwd", "jacrev"])
def test_ilqr_solve_ad_pendulum_matches_jax(use_jacfwd):
    """ilqr.solve with use_fd=False and a coarse lin_dynamics on two
    pendulum swing-ups of a batch: the linearization, costs and plans
    within 1e-5 relative (exact derivatives of the same float32 chain; the
    forward-difference version of this test needs 2e-3)."""
    from robosuite_tpu.mpc import ilqr as jilqr

    H = 20
    x0 = np.array([[0.1, 0.0], [-0.4, 0.3]], np.float32)
    kw = dict(horizon=H, n_iterations=4, use_fd=False, use_jacfwd=use_jacfwd, line_search_steps=6)
    fine_p, coarse_p, cost_p, term_p = _pendulum(torch)
    fine_j, coarse_j, cost_j, term_j = _pendulum(jnp)
    sol_p = ilqr.solve(ilqr.ILQRConfig(**kw), fine_p, cost_p, term_p, torch.as_tensor(x0), torch.zeros(2, H, 1),
                       lin_dynamics=coarse_p)
    solve_j = jax.jit(lambda x: jilqr.solve(jilqr.ILQRConfig(**kw), fine_j, cost_j, term_j, x, jnp.zeros((H, 1)),
                                            lin_dynamics=coarse_j))
    for b in range(2):
        sol_j = solve_j(jnp.asarray(x0[b]))
        _close(sol_p.lin[0][b], sol_j.lin[0], 1e-5)
        _close(sol_p.lin[1][b], sol_j.lin[1], 1e-5)
        _close(sol_p.cost[b], sol_j.cost, 1e-5)
        _close(sol_p.us[b], sol_j.us, 1e-5)
        assert bool(sol_p.metrics["accepted"][-1, b]) == bool(sol_j.metrics["accepted"][-1])


def _random_problem():
    """The JAX package's test_parallel_backward_matches_sequential problem
    (a tanh-coupled system, a cost with cross and linear terms), written
    for both frameworks, with two start states and plans."""
    rng = np.random.default_rng(3)
    nx, nu, H = 5, 2, 16
    W = (rng.normal(size=(nx, nx)) * 0.3).astype(np.float32)
    Bm = rng.normal(size=(nx, nu)).astype(np.float32)
    Q = rng.normal(size=(nx, nx))
    Q = (Q @ Q.T + np.eye(nx)).astype(np.float32)
    P = (rng.normal(size=(nu, nx)) * 0.1).astype(np.float32)
    x0 = rng.normal(size=(2, nx)).astype(np.float32)
    us = (rng.normal(size=(2, H, nu)) * 0.2).astype(np.float32)
    Wt, Bt, Qt, Pt = map(torch.as_tensor, (W, Bm, Q, P))
    torch_fns = (lambda x, u: x + 0.1 * torch.tanh(x @ Wt.T) + 0.1 * (u @ Bt.T),
                 lambda x, u, t: (0.5 * ((x @ Qt) * x).sum(-1) + 0.05 * (u * u).sum(-1) + ((u @ Pt) * x).sum(-1)
                                  + 0.3 * x.sum(-1) + 0.1 * u.sum(-1)),
                 lambda x: 2.0 * (x * x).sum(-1) + 0.2 * x.sum(-1))
    jax_fns = (lambda x, u: x + 0.1 * jnp.tanh(W @ x) + 0.1 * (Bm @ u),
               lambda x, u, t: (0.5 * x @ Q @ x + 0.05 * jnp.sum(u ** 2) + u @ P @ x + 0.3 * jnp.sum(x)
                                + 0.1 * jnp.sum(u)),
               lambda x: 2.0 * jnp.sum(x ** 2) + 0.2 * jnp.sum(x))
    return H, x0, us, torch_fns, jax_fns


@pytest.mark.parametrize("use_jacfwd", [True, False], ids=["jacfwd", "jacrev"])
@pytest.mark.parametrize("parallel_backward", [False, True], ids=["sequential", "associative"])
def test_ilqr_solve_ad_random_problem_matches_jax(use_jacfwd, parallel_backward):
    """Three iterations on the random nonlinear problem, a batch of two
    solves: gains (the last backward pass), plans, costs and the
    linearization within 1e-4 relative of the JAX solve (measured 2e-5 at
    most, the associative pass's, which the port runs in float64 and the
    JAX package in float32), every iteration accepted on both sides."""
    from robosuite_tpu.mpc import ilqr as jilqr

    H, x0, us, (dyn_p, cost_p, term_p), (dyn_j, cost_j, term_j) = _random_problem()
    kw = dict(horizon=H, n_iterations=3, use_fd=False, use_jacfwd=use_jacfwd, parallel_backward=parallel_backward)
    sol_p = ilqr.solve(ilqr.ILQRConfig(**kw), dyn_p, cost_p, term_p, torch.as_tensor(x0), torch.as_tensor(us))
    solve_j = jax.jit(lambda x, u: jilqr.solve(jilqr.ILQRConfig(**kw), dyn_j, cost_j, term_j, x, u))
    for b in range(2):
        sol_j = solve_j(x0[b], us[b])
        for p, j in ((sol_p.gains_k, sol_j.gains_k), (sol_p.gains_K, sol_j.gains_K), (sol_p.us, sol_j.us),
                     (sol_p.cost, sol_j.cost), (sol_p.lin[0], sol_j.lin[0]), (sol_p.lin[1], sol_j.lin[1])):
            _close(p[b], j, 1e-4)
        assert bool(sol_p.metrics["accepted"][:, b].all()) and bool(np.all(np.asarray(sol_j.metrics["accepted"])))


def test_ad_chunks_agree_with_one_call(monkeypatch):
    """Above TANGENT_CHUNK tangent-carrying scenarios the sweep splits into
    calls of at most that many; the linearization does not change."""
    H, x0, us, (dyn_p, cost_p, term_p), _ = _random_problem()
    calls = []

    def counted(x, u):
        calls.append(x.shape[0])
        return dyn_p(x, u)

    cfg = ilqr.ILQRConfig(horizon=H, n_iterations=0, use_fd=False)
    whole = ilqr.solve(cfg, dyn_p, cost_p, term_p, torch.as_tensor(x0), torch.as_tensor(us))
    monkeypatch.setattr(ilqr, "TANGENT_CHUNK", 7 * 5)   # 5 points of nx + nu = 7 copies a call
    split = ilqr.solve(cfg, dyn_p, cost_p, term_p, torch.as_tensor(x0), torch.as_tensor(us), lin_dynamics=counted)
    assert calls == [35] * 6 + [14]   # 2 * 16 points in chunks of 5
    for a, b in zip(whole.lin, split.lin):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_backward_associative_matches_jax_and_sequential():
    """backward_associative on random LQ data (two solves, each with its own
    regularisation): gains, expected improvement and the cost-to-go
    (Ss, ss) within 1e-4 relative of the JAX pass (float32 there, float64
    in the port), and the gains within the JAX package's own
    associative-vs-sequential tolerance (rtol 2e-4, atol 2e-5;
    tests/test_mpc.py) of the port's sequential pass; the outputs keep the
    inputs' float32."""
    from robosuite_tpu.mpc import ilqr as jilqr

    rng = np.random.default_rng(7)
    B, H, nx, nu = 2, 9, 6, 3

    def spd(*shape):
        a = rng.normal(size=shape + (shape[-1],))
        return a @ np.swapaxes(a, -1, -2) + np.eye(shape[-1])

    fx = np.eye(nx) + 0.1 * rng.normal(size=(B, H, nx, nx))
    fu = 0.3 * rng.normal(size=(B, H, nx, nu))
    cx, cu = rng.normal(size=(B, H, nx)), rng.normal(size=(B, H, nu))
    cxx, cuu = spd(B, H, nx), spd(B, H, nu)
    cux = 0.1 * rng.normal(size=(B, H, nu, nx))
    Vx, Vxx = rng.normal(size=(B, nx)), spd(B, nx)
    reg = np.array([1e-3, 0.5])
    args = [np.asarray(a, np.float32) for a in (fx, fu, cx, cu, cxx, cuu, cux, Vx, Vxx, reg)]
    targs = [torch.as_tensor(a) for a in args]
    ks, Ks, dv, Ss, ss = ilqr.backward_associative(*targs)
    assert Ss.shape == (B, H + 1, nx, nx) and ss.shape == (B, H + 1, nx) and Ks.dtype == torch.float32
    bwd = jax.jit(jilqr.backward_associative)
    for b in range(B):
        out_j = bwd(*(jnp.asarray(a[b]) for a in args))
        for p, j in zip((ks[b], Ks[b], dv[b], Ss[b], ss[b]), out_j):
            _close(p, j, 1e-4)
    ks_s, Ks_s, dv_s = ilqr.backward_sequential(*targs)
    np.testing.assert_allclose(ks.numpy(), ks_s.numpy(), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(Ks.numpy(), Ks_s.numpy(), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(dv.numpy(), dv_s.numpy(), rtol=2e-4)
