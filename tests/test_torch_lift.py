"""The slice: the port's batched Lift-Panda policy step (rollout_batch, on
the CPU its plain path) against the JAX package's _rollout_impl, from the
same flattened state injected into both (state_from_flattened).

The state is the JAX env's after 5 zero-action policy steps from a reset,
so the cube rests on the table (no impact within the compared steps).
Bounds: 1 policy step qpos, qvel and reward 1e-4; 3 steps arm qpos 1e-3
(the contact-rich growth tests/test_engine_trajectory.py allows). Also the
OSC torques against robosuite's recorded torques along a Lift rollout
(tests/fixtures/osc_probe_panda_rollout.npz) within 1e-3, as
tests/test_osc_parity.py holds the JAX package."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robosuite_tpu_torch.ops import forward
from tests.test_torch_door import one_thread  # noqa: F401  (an autouse fixture: one torch thread)

CUBE = [0.021, 0.021, 0.021]
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "osc_probe_panda_rollout.npz")


@pytest.fixture(scope="module")
def setup():
    import robosuite_tpu
    import robosuite_tpu_torch

    jenv = robosuite_tpu.make("Lift", robots="Panda", cube_size=CUBE, reward_shaping=True)
    penv = robosuite_tpu_torch.make("Lift", robots="Panda", cube_size=CUBE, reward_shaping=True, device="cpu")
    jstep = jax.jit(jenv._rollout_impl)
    state, _ = jenv.reset(jax.random.PRNGKey(0))
    zero = jnp.zeros(jenv.action_dim)
    for _ in range(5):
        state, _ = jstep(state, zero)
    flat = np.asarray(state.physics.flatten())
    jenv.state_from_flattened = jax.jit(jenv.state_from_flattened)
    return jenv, penv, jstep, flat


def _actions(n, dim):
    rng = np.random.default_rng(1)
    a = (0.3 * rng.standard_normal((n, dim))).astype(np.float32)
    a[:, -1] = 1.0  # close the gripper
    return a


def test_one_policy_step_matches_jax(setup):
    jenv, penv, jstep, flat = setup
    a = _actions(1, jenv.action_dim)[0]
    js, jr = jstep(jenv.state_from_flattened(flat), jnp.asarray(a))
    ps, pr = penv.rollout_batch(penv.state_from_flattened(flat[None]), torch.as_tensor(a)[None])
    np.testing.assert_allclose(ps.physics.qpos[0].numpy(), np.asarray(js.physics.qpos), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ps.physics.qvel[0].numpy(), np.asarray(js.physics.qvel), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(pr[0]), float(jr), rtol=0, atol=1e-4)
    # the controller state carried to the next step
    np.testing.assert_allclose(ps.ctrl.arm["right"].goal_pos[0].numpy(), np.asarray(js.ctrl.arm["right"].goal_pos),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(ps.ctrl.gripper_action["right"][0].numpy(),
                               np.asarray(js.ctrl.gripper_action["right"]), rtol=0, atol=1e-6)


def test_three_policy_steps_arm_matches_jax(setup):
    jenv, penv, jstep, flat = setup
    acts = _actions(3, jenv.action_dim)
    js = jenv.state_from_flattened(flat)
    ps = penv.state_from_flattened(flat[None])
    for a in acts:
        js, _ = jstep(js, jnp.asarray(a))
        ps, _ = penv.rollout_batch(ps, torch.as_tensor(a)[None])
    np.testing.assert_allclose(ps.physics.qpos[0, :7].numpy(), np.asarray(js.physics.qpos)[:7], rtol=0, atol=1e-3)
    assert torch.isfinite(ps.physics.qpos).all() and torch.isfinite(ps.physics.qvel).all()


def test_reset_batch_and_fused_unfused_agree(setup):
    """reset_batch gives finite states and the Lift observations through
    the Observable pipeline, as the JAX reset gives them (the eef force and
    torque, the '<modality>-state' vectors, and placement_valid, see
    test_reset_reports_placement_valid); the fused
    substep path and the unfused one (forward products + contact solve per
    substep) agree on the CPU."""
    _, penv, _, _ = setup
    gen = torch.Generator().manual_seed(0)
    states, obs = penv.reset_batch(2, gen)
    assert set(obs) == {
        "robot0_joint_pos", "robot0_joint_pos_cos", "robot0_joint_pos_sin", "robot0_joint_vel",
        "robot0_eef_pos", "robot0_eef_quat", "robot0_gripper_qpos", "robot0_gripper_qvel",
        "cube_pos", "cube_quat", "gripper_to_cube_pos", "placement_valid",
        "robot0_eef_force", "robot0_eef_torque", "robot0_proprio-state", "object-state",
    }
    assert all(torch.isfinite(v).all() for v in obs.values())
    a = torch.as_tensor(_actions(2, penv.action_dim))
    s1, r1 = penv.rollout_batch(states, a)
    penv._disable_fused = True
    try:
        s2, r2 = penv.rollout_batch(states, a)
    finally:
        penv._disable_fused = False
    torch.testing.assert_close(s1.physics.qpos, s2.physics.qpos, rtol=0, atol=1e-6)
    torch.testing.assert_close(r1, r2, rtol=0, atol=1e-6)


def test_reset_reports_placement_valid(setup):
    """Lift's sampler reports no validity, so reset_batch's placement_valid
    is all True, as the JAX reset's is (it carries the key for every env)."""
    jenv, penv, _, _ = setup
    _, obs = penv.reset_batch(3, torch.Generator().manual_seed(1))
    assert obs["placement_valid"].dtype == torch.bool and obs["placement_valid"].shape == (3,)
    assert bool(obs["placement_valid"].all())
    _, jobs = jenv.reset(jax.random.PRNGKey(1))
    assert bool(np.asarray(jobs["placement_valid"]))


def test_osc_torques_match_robosuite_fixture(setup):
    """OSC torques through the port's forward products and controller,
    against robosuite's recorded torques at states along a Lift rollout."""
    from robosuite_tpu_torch.controllers.parts import osc

    _, penv, _, _ = setup
    probe = np.load(FIXTURE)
    robot = penv.robots[0]
    qpos = torch.as_tensor(probe["qpos"], dtype=torch.float32)
    qvel = torch.as_tensor(probe["qvel"], dtype=torch.float32)
    kin, M, bias = forward.forward_products(penv.model, qpos, qvel)
    view = robot.arm_view(kin, M, bias, qpos, qvel, "right")
    view = dataclasses.replace(view, initial_joint=torch.as_tensor(probe["initial_joint"], dtype=torch.float32))
    cfg = robot.arm_cfg["right"]
    st = osc.set_goal(cfg, osc.init_state(cfg, view), view,
                      torch.as_tensor(probe["action"][:, :6], dtype=torch.float32))
    tau = osc.run(cfg, st, view).numpy()
    err = np.abs(tau - probe["torques"]).max(axis=1)
    assert err.mean() <= 1e-3 and err.max() <= 1e-3, (err.mean(), err.max())


def test_state_from_numpy_carries_controller_state(setup):
    """A JAX env state after one policy step (its controller goals and the
    gripper ramp) carried into the port with convert.state_from_numpy: the
    next policy step agrees."""
    from robosuite_tpu_torch import convert

    jenv, penv, jstep, flat = setup
    a1, a2 = _actions(2, jenv.action_dim)
    js, _ = jstep(jenv.state_from_flattened(flat), jnp.asarray(a1))
    osc_j = js.ctrl.arm["right"]
    ps = convert.state_from_numpy(
        np.asarray(js.physics.qpos)[None], np.asarray(js.physics.qvel)[None],
        {"goal_pos": np.asarray(osc_j.goal_pos)[None], "goal_ori": np.asarray(osc_j.goal_ori)[None],
         "kp": np.asarray(osc_j.kp)[None], "kd": np.asarray(osc_j.kd)[None],
         "gripper_action": np.asarray(js.ctrl.gripper_action["right"])[None]}, device="cpu")
    js2, jr2 = jstep(js, jnp.asarray(a2))
    ps2, pr2 = penv.rollout_batch(ps, torch.as_tensor(a2)[None])
    np.testing.assert_allclose(ps2.physics.qpos[0, :9].numpy(), np.asarray(js2.physics.qpos)[:9], rtol=0, atol=1e-4)
    np.testing.assert_allclose(ps2.ctrl.gripper_action["right"][0].numpy(),
                               np.asarray(js2.ctrl.gripper_action["right"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(pr2[0]), float(jr2), rtol=0, atol=1e-4)
