"""The iLQR's AD linearization of the whole planning dynamics (the env's
goals and substeps on the linearization model) on the CPU against
jax.jacfwd of the JAX harness's _ilqr_lin_dynamics: Lift (fused on the
card: K1, then K3) and TwoArmPegInHole (unfused on the card: K1, the
contact rows, K2), H=2 and B=2 from the JAX reset states carried across
with convert.state_from_numpy, each column of fx and fu within 1e-3 of
its largest entry.

The JAX jacfwd is NaN through two derivatives at 0 of its own code: the
norm of a box-box edge pair's zero cross axis (pallas_substep._norm3,
where parallel edges give a masked candidate) and the power iteration's
jnp.linalg.norm on a scenario with no active row; jnp.maximum's jvp then
multiplies the NaN by its 0 mask. For this test the two are replaced,
inside this process only, by functions of the same value whose
derivative at 0 is 0 (torch's convention, which the port's plain code
gets from torch.clamp_min and vector_norm). Marked slow: XLA:CPU lowers
and compiles each world's jacfwd for about four minutes."""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robosuite_tpu_torch import convert
from robosuite_tpu_torch.mpc import ilqr, receding
from tests.test_torch_door import one_thread  # noqa: F401  (an autouse fixture: one torch thread)

WORLDS = {"Lift": dict(robots="Panda", cube_size=[0.021] * 3, reward_shaping=True),
          "TwoArmPegInHole": dict(robots=("Panda", "Panda"), env_configuration="opposed", reward_shaping=True)}
CFG = dict(horizon=2, n_samples=3, n_knots=2, n_ilqr_iters=1, plan_timestep=0.025, fd_timestep=0.05,
           plan_pair_points=2)


@contextlib.contextmanager
def zero_derivative_norms_at_zero():
    from robosuite_tpu.ops import pallas_substep as PS

    @jax.custom_jvp
    def norm3(a, b, c):
        return jnp.sqrt(a * a + b * b + c * c)

    @norm3.defjvp
    def _norm3_jvp(p, t):
        n = norm3(*p)
        inv = jnp.where(n > 0, 1.0 / jnp.where(n > 0, n, 1.0), 0.0)
        return n, inv * sum(x * tx for x, tx in zip(p, t))

    @jax.custom_jvp
    def vnorm(x):
        return jnp.sqrt(jnp.sum(x * x))

    @vnorm.defjvp
    def _vnorm_jvp(p, t):
        (x,), (tx,) = p, t
        n = vnorm(x)
        return n, jnp.where(n > 0, jnp.vdot(x, tx) / jnp.where(n > 0, n, 1.0), 0.0)

    orig_norm3, orig_norm = PS._norm3, jnp.linalg.norm

    def norm(x, ord=None, axis=None, keepdims=False):
        if ord is None and axis is None and not keepdims and x.ndim == 1:
            return vnorm(x)
        return orig_norm(x, ord=ord, axis=axis, keepdims=keepdims)

    PS._norm3 = lambda v, eps=1e-9: norm3(v[0], v[1], v[2])
    jnp.linalg.norm = norm
    try:
        yield
    finally:
        PS._norm3, jnp.linalg.norm = orig_norm3, orig_norm


@pytest.mark.slow
@pytest.mark.parametrize("name", list(WORLDS))
def test_jacfwd_linearization_matches_jax(name):
    import robosuite_tpu
    import robosuite_tpu_torch
    from robosuite_tpu.mpc import receding as jreceding

    jenv = robosuite_tpu.make(name, **WORLDS[name])
    penv = robosuite_tpu_torch.make(name, device="cpu", **WORLDS[name])
    jmpc = jreceding.RecedingMPC(jenv, jreceding.MPCConfig(**CFG))
    pmpc = receding.RecedingMPC(penv, receding.MPCConfig(**CFG))
    assert pmpc.nx == jmpc.nx
    js = jenv.reset_batch(jax.random.split(jax.random.PRNGKey(0), 2))[0]
    ps = convert.state_from_numpy(convert.numpy_tree(js), device="cpu")
    x0 = pmpc._to_x(ps)
    np.testing.assert_array_equal(x0.numpy(), np.asarray(jax.vmap(jmpc._to_x)(js)))
    us = 0.3 * torch.randn(2, 2, penv.action_dim, generator=torch.Generator().manual_seed(5))
    # the AD sweep itself, about the nominal rollout of the plans
    xs = [x0]
    for h in range(2):
        xs.append(pmpc._ilqr_dynamics(xs[-1], us[:, h]))
    X = torch.stack(xs[:2], 1).reshape(4, -1)
    U = us.reshape(4, -1)
    fx_p, fu_p = ilqr.linearize_ad(pmpc._ilqr_lin_dynamics, X, U, use_jacfwd=True)
    with zero_derivative_norms_at_zero():
        fx_j, fu_j = jax.jit(jax.vmap(jax.jacfwd(jmpc._ilqr_lin_dynamics, argnums=(0, 1))))(X.numpy(), U.numpy())
    for p, j in ((fx_p, fx_j), (fu_p, fu_j)):
        j = np.asarray(j)
        assert np.isfinite(j).all() and bool(torch.isfinite(p).all())
        scale = np.maximum(np.abs(j).max(axis=-2, keepdims=True), 1e-6)
        err = np.abs(p.numpy() - j) / scale
        print(f"{name}: the port's jacfwd against jax.jacfwd, largest error relative to its column {err.max():.3e}")
        assert err.max() <= 1e-3, (name, float(err.max()), np.unravel_index(err.argmax(), err.shape))
