"""One MPPI-only solve_batch of Lift-PandaOmron (HYBRID_MOBILE_BASE: the
planning rollouts carry the base's MobileBaseState, its initial yaw
among it, and the base-mode flag picks the arm's OSC goal frame) in the
port against the JAX package on the CPU, with the JAX draw injected
(tests/test_torch_last_envs_step.py's harness: the JAX package's
mppi_step_batch run twice around the planning rollouts of its step
pieces): B=1, K=2, H=2, 2 knots, the planning model at the 500 Hz env's
2 ms (one substep a planned step, 10 solver iterations), from
test_torch_mobile_robots.pressed_state injected into both; the actions
and the shifted plans within 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_last_envs_step import MPPI, jax_mppi_solve, jax_pieces
from tests.test_torch_mobile_robots import pressed_state


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_pandaomron_mppi_solve_matches_jax():
    import robosuite_tpu
    import robosuite_tpu_torch
    from robosuite_tpu.mpc import receding as jreceding
    from robosuite_tpu.physics import contact as JC

    from robosuite_tpu_torch.mpc import receding

    kw = dict(robots="PandaOmron", reward_shaping=True, control_freq=500, seed=0)
    jenv, penv = robosuite_tpu.make("Lift", **kw), robosuite_tpu_torch.make("Lift", device="cpu", **kw)
    flat = pressed_state(penv)[:1]
    cfg = dict(MPPI, plan_timestep=0.002)
    jmpc = jreceding.RecedingMPC(jenv, jreceding.MPCConfig(**cfg))
    pmpc = receding.RecedingMPC(penv, receding.MPCConfig(**cfg))
    plan = jmpc.plan_model
    assert jmpc.plan_substeps == pmpc.plan_substeps == 1 and plan.pair_points_cap is None
    pieces = jax_pieces(jenv, jenv.model)
    js = pieces["from_flat"](jnp.asarray(flat))
    mss = jax.tree.map(lambda x: x[None], jmpc.init_state(jax.random.PRNGKey(3)))
    keys = jax.vmap(jax.random.split)(mss.rng)
    knots = np.array(jax.vmap(lambda key: jax.random.normal(key, (2, 2, penv.action_dim)))(keys[:, 1]))
    power = JC.POWER_ITERS if plan.solver_power_iters is None else plan.solver_power_iters
    means = np.asarray(jax_mppi_solve(jmpc, js, mss, dict(pieces, substep=pieces["substep_with"](plan.solver_iters,
                                                                                              power))))
    ps = penv.state_from_flattened(flat)
    assert ps.ctrl.arm["base"].init_yaw.shape == (1,)
    a_p, ms2, met = pmpc.make_solve_batch()(ps, pmpc.init_state(1, None), knots=torch.as_tensor(knots))
    assert np.isfinite(means).all() and a_p.shape == (1, 12)
    np.testing.assert_allclose(a_p.numpy(), means[:, 0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(ms2.us.numpy()[:, :-1], means[:, 1:], rtol=0, atol=1e-4)
    assert not bool(ms2.us[:, -1].any()) and int(met["n_masked"].sum()) == 0
