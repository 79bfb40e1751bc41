"""The port's MPC planning hooks (RobotEnv.make_plan_return, the fused
emit_aux rollout, and make_plan_dynamics) on the 2-point planning model,
on the CPU against the JAX package's hooks, from the same states (the cube
resting on the table), carried to both envs with state_from_flattened."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_substep import CUBE, contact_states
from tests.test_torch_door import one_thread  # noqa: F401  (an autouse fixture: one torch thread)

PLAN = dict(timestep=0.025, solver_iters=10, pair_points_cap=2)


def resting_states():
    """(jenv, penv, flat (2, 1 + nq + nv), JAX EnvStates): two Lift
    scenarios with the arm near its initial pose (moving) and the cube
    resting on the table, 1.2 mm deep (tests/test_torch_substep.py)."""
    import robosuite_tpu
    import robosuite_tpu_torch

    jenv = robosuite_tpu.make("Lift", robots="Panda", cube_size=CUBE, reward_shaping=True)
    penv = robosuite_tpu_torch.make("Lift", robots="Panda", cube_size=CUBE, reward_shaping=True, device="cpu")
    qpos, qvel = contact_states(np.random.default_rng(7), 2)
    flat = np.concatenate([np.zeros((2, 1), np.float32), qpos, qvel], axis=1)
    from_flat = jax.jit(jenv.state_from_flattened)
    return jenv, penv, flat, [from_flat(jnp.asarray(f)) for f in flat]


@pytest.fixture(scope="module")
def setup():
    return resting_states()


def test_plan_return_and_dynamics_match_jax(setup):
    """make_plan_return (H=3, fused emit_aux form) and make_plan_dynamics
    (one step, fused form) of the planning model. Bounds: the returns 1e-4
    (three rewards, each held to 1e-4 in tests/test_torch_lift.py), one
    planned step's qpos 1e-5 and qvel 1e-4 (two substeps, as one substep
    in tests/test_torch_substep.py)."""
    jenv, penv, flat, jstates = setup
    jplan, pplan = jenv.model.replace(**PLAN), penv.model.replace(**PLAN)
    rng = np.random.default_rng(0)
    seqs = rng.uniform(-1, 1, (2, 3, penv.action_dim)).astype(np.float32)
    disc = np.ones(3, np.float32)
    ret_p = penv.make_plan_return(pplan, 2)(penv.state_from_flattened(flat), torch.as_tensor(seqs),
                                            torch.as_tensor(disc))
    ret_j = jax.jit(jenv.make_plan_return(jplan, 2))
    for b in range(2):
        np.testing.assert_allclose(float(ret_p[b]), float(ret_j(jstates[b], jnp.asarray(seqs[b]), jnp.asarray(disc))),
                                   rtol=0, atol=1e-4)

    dyn_p = penv.make_plan_dynamics(pplan, 2)(penv.state_from_flattened(flat), torch.as_tensor(seqs[:, 0]))
    dyn_j = jax.jit(jenv.make_plan_dynamics(jplan, 2))
    for b in range(2):
        sj = dyn_j(jstates[b], jnp.asarray(seqs[b, 0]))
        np.testing.assert_allclose(dyn_p.physics.qpos[b].numpy(), np.asarray(sj.physics.qpos), rtol=0, atol=1e-5)
        np.testing.assert_allclose(dyn_p.physics.qvel[b].numpy(), np.asarray(sj.physics.qvel), rtol=0, atol=1e-4)
        np.testing.assert_allclose(dyn_p.ctrl.gripper_action["right"][b].numpy(),
                                   np.asarray(sj.ctrl.gripper_action["right"]), rtol=0, atol=1e-6)


def test_plan_return_unfused_matches_fused(setup):
    """With the fused substep disabled, make_plan_return carries the
    forward products policy step to policy step (the product-carrying
    fallback); on the CPU both forms are plain PyTorch and agree to 1e-5
    (the reward reads the narrowphase instead of the aux pair distances)."""
    _, penv, flat, _ = setup
    pplan = penv.model.replace(**PLAN)
    seqs = torch.as_tensor(np.random.default_rng(3).uniform(-1, 1, (2, 2, penv.action_dim)).astype(np.float32))
    disc = torch.tensor([1.0, 0.9])
    states = penv.state_from_flattened(flat)
    fused = penv.make_plan_return(pplan, 2)(states, seqs, disc)
    penv._disable_fused = True
    try:
        unfused = penv.make_plan_return(pplan, 2)(states, seqs, disc)
    finally:
        penv._disable_fused = False
    torch.testing.assert_close(unfused, fused, rtol=0, atol=1e-5)
