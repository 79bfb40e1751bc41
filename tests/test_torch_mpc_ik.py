"""The MPC on Lift-Panda with the IK_POSE arm (unfused: its planning
rollouts run the product-carrying policy steps, the IK solve at every
planned step): an MPPI-only solve_batch (B=2, K=4, H=3, 2 knots) from the
states of tests/test_torch_lift_ctrl_joint.py, carried across from the JAX
package, with the JAX draw injected; actions and shifted plans within
1e-4, as tests/test_torch_mpc.py holds the OSC solve. Marked slow: the
JAX side's XLA:CPU compile of this solve takes about 80 s (the test 92 s
on one thread); run it with -m slow when the unfused planning path or
the IK changes."""

import numpy as np
import pytest
import torch

import jax

from robosuite_tpu_torch.mpc import receding
from tests.test_torch_door import one_thread  # noqa: F401  (an autouse fixture: one torch thread)
from tests.test_torch_lift_ctrl_joint import B, carry, lift_pair
from tests.test_torch_mpc import _cfg, _jax_knots


@pytest.mark.slow
def test_ik_mppi_solve_matches_jax():
    import jax.numpy as jnp
    from robosuite_tpu.mpc import receding as jreceding

    jenv, penv, _, js = lift_pair("IK_POSE", "IK_POSE")
    jmpc = jreceding.RecedingMPC(jenv, _cfg(jreceding))
    pmpc = receding.RecedingMPC(penv, _cfg(receding))
    ms0 = jmpc.init_state(jax.random.PRNGKey(3))
    mss = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (B,) + x.shape), ms0)
    knots = _jax_knots(mss, (4, 2, penv.action_dim))
    a_j, mss2, _ = jax.jit(jmpc.make_solve_batch())(js, mss)
    a_p, ms2, met = pmpc.make_solve_batch()(carry(js), pmpc.init_state(B, None), knots=torch.as_tensor(knots))
    np.testing.assert_allclose(a_p.numpy(), np.asarray(a_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ms2.us.numpy(), np.asarray(mss2.us), rtol=0, atol=1e-4)
    assert int(met["n_masked"].sum()) == 0
