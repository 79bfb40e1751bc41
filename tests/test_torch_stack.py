"""The Panda-Stack slice with the JOINT_POSITION controller: the port on the
CPU (its plain path) against the JAX package on the same inputs.

  * one fused substep (ops/substep.substep_plain, the JOINT_POSITION law)
    against the JAX make_fused_substep called unbatched (its _xla
    composition), at states with both cubes resting on the table: qpos
    1e-5, qvel 1e-4, as tests/test_torch_substep.py holds Lift's;
  * one policy step from a JAX reset state injected into both
    (state_from_flattened): qpos, qvel and reward 1e-4, the carried
    goal_qpos 1e-5; three policy steps: arm qpos 1e-3 (as
    tests/test_torch_lift.py); a JAX controller state carried across with
    convert.state_from_numpy;
  * the fused and unfused plain paths agree to 1e-6;
  * the Stack planning residual against the JAX one: 1e-5;
  * utils/placement.sample_placements keeps the cubes apart by their
    horizontal radii, on the table, with the validity flag.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robosuite_tpu_torch.ops import forward, substep
from tests.test_torch_substep import INIT
from tests.test_torch_door import one_thread  # noqa: F401  (an autouse fixture: one torch thread)

JP = dict(robots="Panda", controller_configs="JOINT_POSITION", reward_shaping=True)


def contact_states(rng, B):
    """(qpos (B, 23), qvel (B, 21)): the arm near its init pose (moving),
    cubeA (half size 0.02) and cubeB (0.025) resting apart on the table,
    1.2 mm deep, each at a random yaw."""
    qpos = np.zeros((B, 23), np.float32)
    qpos[:, :7] = INIT + 0.2 * rng.standard_normal((B, 7))
    qpos[:, 7:9] = [0.02, -0.02]
    for start, half, x_lo, x_hi in ((9, 0.02, -0.07, -0.03), (16, 0.025, 0.03, 0.07)):
        qpos[:, start] = rng.uniform(x_lo, x_hi, B)
        qpos[:, start + 1] = rng.uniform(-0.05, 0.05, B)
        qpos[:, start + 2] = 0.8 + half - 0.0012
        yaw = rng.uniform(0, 2 * np.pi, B)
        qpos[:, start + 3], qpos[:, start + 6] = np.cos(yaw / 2), np.sin(yaw / 2)
    qvel = np.zeros((B, 21), np.float32)
    qvel[:, :7] = 0.1 * rng.standard_normal((B, 7))
    return qpos, qvel


def resting_states():
    """(jenv, penv, flat (2, 1 + nq + nv), JAX EnvStates): two Stack
    scenarios at contact_states (numpy seed 7), carried to both envs with
    state_from_flattened."""
    import robosuite_tpu
    import robosuite_tpu_torch

    jenv = robosuite_tpu.make("Stack", **JP)
    penv = robosuite_tpu_torch.make("Stack", device="cpu", **JP)
    qpos, qvel = contact_states(np.random.default_rng(7), 2)
    flat = np.concatenate([np.zeros((2, 1), np.float32), qpos, qvel], axis=1)
    from_flat = jax.jit(jenv.state_from_flattened)
    return jenv, penv, flat, [from_flat(jnp.asarray(f)) for f in flat]


@pytest.fixture(scope="module")
def setup():
    """(jenv, penv, jstep, flat (1, 1 + nq + nv)): the JAX env's state after
    a reset and 5 zero-action policy steps (the cubes have landed)."""
    import robosuite_tpu
    import robosuite_tpu_torch

    jenv = robosuite_tpu.make("Stack", **JP)
    penv = robosuite_tpu_torch.make("Stack", device="cpu", **JP)
    jstep = jax.jit(jenv._rollout_impl)
    state, _ = jenv.reset(jax.random.PRNGKey(0))
    zero = jnp.zeros(jenv.action_dim)
    for _ in range(5):
        state, _ = jstep(state, zero)
    jenv.state_from_flattened = jax.jit(jenv.state_from_flattened)
    return jenv, penv, jstep, np.asarray(state.physics.flatten())[None]


def _actions(n, dim):
    rng = np.random.default_rng(1)
    a = (0.5 * rng.standard_normal((n, dim))).astype(np.float32)
    a[:, -1] = 1.0  # close the gripper
    return a


def test_world_and_spec_match_jax(setup):
    """The Stack world's sizes and the fused substep's arm spec."""
    from robosuite_tpu.ops.pallas_substep import extract_spec as jextract

    from robosuite_tpu_torch.physics import contact as C

    jenv, penv, _, _ = setup
    m = penv.model
    assert (m.nq, m.nv, m.nbody, m.ngeom, m.nsite, m.nu, m.npair) == (23, 21, 27, 92, 10, 9, 26)
    assert sum(len(r) for r in C.contact_row_layout(m).values()) == 96
    assert penv.action_dim == jenv.action_dim == 8
    spec, jspec = substep.extract_spec(penv, m), jextract(jenv, jenv.model).arm
    assert spec["ctrl_type"] == jspec.ctrl_type == "joint_pos"
    assert spec["use_torque_compensation"] == jspec.use_torque_compensation
    assert spec["qp_idx"] == list(jspec.qp_idx) and spec["actuator_ids"] == list(jspec.actuator_ids)


def test_substep_matches_jax(setup):
    from robosuite_tpu.ops.pallas_substep import make_fused_substep

    jenv, penv, _, _ = setup
    jm, pm = jenv.model, penv.model
    jfused = jax.jit(make_fused_substep(jenv, jm))
    rng = np.random.default_rng(0)
    B = 3
    qpos, qvel = contact_states(rng, B)
    goal = (qpos[:, :7] + 0.02 * rng.standard_normal((B, 7))).astype(np.float32)
    gains = np.tile(np.concatenate([np.full(7, 50.0), np.full(7, 2 * np.sqrt(50.0))]), (B, 1)).astype(np.float32)
    grip = np.tile(np.array([0.02, -0.02], np.float32), (B, 1))
    fused = substep.make_fused_substep(penv, pm)
    leaves = forward.runtime_leaves(pm, B)
    qp_p, qv_p, f_p = fused(torch.as_tensor(qpos), torch.as_tensor(qvel), *leaves, torch.as_tensor(goal),
                            torch.as_tensor(gains), torch.as_tensor(grip))
    assert substep.make_fused_substep.launches == 0  # CPU tensors never reach the kernel
    assert f_p.shape == (B, 288)
    for b in range(B):
        qp_j, qv_j, _ = jfused(jnp.asarray(qpos[b]), jnp.asarray(qvel[b]), jm.body_mass, jm.body_inertia, jm.gravity,
                               jm.dof_armature, jnp.asarray(goal[b]), jnp.asarray(gains[b]), jnp.asarray(grip[b]))
        np.testing.assert_allclose(qp_p[b].numpy(), np.asarray(qp_j), rtol=0, atol=1e-5)
        np.testing.assert_allclose(qv_p[b].numpy(), np.asarray(qv_j), rtol=0, atol=1e-4)


def test_one_policy_step_matches_jax(setup):
    jenv, penv, jstep, flat = setup
    a = _actions(1, jenv.action_dim)[0]
    js, jr = jstep(jenv.state_from_flattened(flat[0]), jnp.asarray(a))
    ps, pr = penv.rollout_batch(penv.state_from_flattened(flat), torch.as_tensor(a)[None])
    np.testing.assert_allclose(ps.physics.qpos[0].numpy(), np.asarray(js.physics.qpos), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ps.physics.qvel[0].numpy(), np.asarray(js.physics.qvel), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(pr[0]), float(jr), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ps.ctrl.arm["right"].goal_qpos[0].numpy(), np.asarray(js.ctrl.arm["right"].goal_qpos),
                               rtol=0, atol=1e-5)


def test_three_policy_steps_arm_matches_jax(setup):
    jenv, penv, jstep, flat = setup
    js, ps = jenv.state_from_flattened(flat[0]), penv.state_from_flattened(flat)
    for a in _actions(3, jenv.action_dim):
        js, _ = jstep(js, jnp.asarray(a))
        ps, _ = penv.rollout_batch(ps, torch.as_tensor(a)[None])
    np.testing.assert_allclose(ps.physics.qpos[0, :7].numpy(), np.asarray(js.physics.qpos)[:7], rtol=0, atol=1e-3)
    assert torch.isfinite(ps.physics.qpos).all() and torch.isfinite(ps.physics.qvel).all()


def test_state_from_numpy_carries_joint_position_state(setup):
    """A JAX controller state (goal_qpos, kp, kd, gripper ramp) after one
    policy step, carried into the port: the next policy step agrees."""
    from robosuite_tpu_torch import convert

    jenv, penv, jstep, flat = setup
    a1, a2 = _actions(2, jenv.action_dim)
    js, _ = jstep(jenv.state_from_flattened(flat[0]), jnp.asarray(a1))
    jp_j = js.ctrl.arm["right"]
    leaves = {k: np.asarray(getattr(jp_j, k))[None] for k in ("goal_qpos", "kp", "kd")}
    leaves["gripper_action"] = np.asarray(js.ctrl.gripper_action["right"])[None]
    ps = convert.state_from_numpy(np.asarray(js.physics.qpos)[None], np.asarray(js.physics.qvel)[None], leaves,
                                  device="cpu")
    js2, jr2 = jstep(js, jnp.asarray(a2))
    ps2, pr2 = penv.rollout_batch(ps, torch.as_tensor(a2)[None])
    np.testing.assert_allclose(ps2.physics.qpos[0, :9].numpy(), np.asarray(js2.physics.qpos)[:9], rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(pr2[0]), float(jr2), rtol=0, atol=1e-4)


def test_reset_batch_and_fused_unfused_agree(setup):
    """reset_batch gives finite states, the raw Stack observations and the
    placement flag; the fused substep path and the unfused one agree on
    the CPU."""
    _, penv, _, _ = setup
    states, obs = penv.reset_batch(2, torch.Generator().manual_seed(0))
    assert {"cubeA_pos", "cubeB_quat", "cubeA_to_cubeB", "gripper_to_cubeA", "placement_valid"} <= set(obs)
    assert all(torch.isfinite(v.float()).all() for v in obs.values())
    assert bool(obs["placement_valid"].all())
    a = torch.as_tensor(_actions(2, penv.action_dim))
    s1, r1 = penv.rollout_batch(states, a)
    penv._disable_fused = True
    try:
        s2, r2 = penv.rollout_batch(states, a)
    finally:
        penv._disable_fused = False
    torch.testing.assert_close(s1.physics.qpos, s2.physics.qpos, rtol=0, atol=1e-6)
    torch.testing.assert_close(s1.physics.qvel, s2.physics.qvel, rtol=0, atol=1e-6)
    torch.testing.assert_close(r1, r2, rtol=0, atol=1e-6)


def test_stack_residual_matches_jax(setup):
    from robosuite_tpu.mpc import residuals as jres

    from robosuite_tpu_torch.mpc import residuals

    jenv, penv, _, _ = setup
    qpos, qvel = contact_states(np.random.default_rng(3), 3)
    qpos[1, 9:12] = qpos[1, 16:19] + [0.0, 0.0, 0.045]  # cubeA held above cubeB
    u = np.zeros((3, 8), np.float32)
    assert residuals.residual_for(penv) is residuals.stack_residual
    r_p = residuals.stack_residual(penv, penv.model, torch.as_tensor(qpos), torch.as_tensor(qvel), torch.as_tensor(u))
    for b in range(3):
        r_j = jres.stack_residual(jenv, jenv.model, jnp.asarray(qpos[b]), jnp.asarray(qvel[b]), jnp.asarray(u[b]))
        np.testing.assert_allclose(r_p[b].numpy(), np.asarray(r_j), rtol=0, atol=1e-5)


def test_sample_placements_keeps_cubes_apart(setup):
    """Each scenario's cubes stand on the table inside their ranges, their
    centres further apart than the sum of their horizontal radii, with a
    unit z-rotation quaternion; a draw with no free spot is flagged."""
    from robosuite_tpu_torch.utils import placement as P

    _, penv, _, _ = setup
    n = 256
    idx, vals, valid = P.sample_placements(penv._placements, n, torch.Generator().manual_seed(5))
    assert idx == list(range(9, 16)) + list(range(16, 23)) and vals.shape == (n, 14) and bool(valid.all())
    a, b = vals[:, :7], vals[:, 7:]
    ra, rb = (s.horizontal_radius for s in penv._placements)
    assert bool((torch.linalg.vector_norm(a[:, :2] - b[:, :2], dim=-1) > ra + rb).all())
    for v, half in ((a, 0.02), (b, 0.025)):
        assert bool((v[:, :2].abs() <= 0.08).all())
        torch.testing.assert_close(v[:, 2], torch.full((n,), 0.8 + half + 0.01), rtol=0, atol=1e-6)
        torch.testing.assert_close(torch.linalg.vector_norm(v[:, 3:], dim=-1), torch.ones(n), rtol=0, atol=1e-6)
        assert bool((v[:, 4:6] == 0).all())
    # a second object that cannot fit beside the first in any candidate
    tight = [P.PlacementSpec("a", 0, horizontal_radius=0.1), P.PlacementSpec("b", 7, horizontal_radius=0.1)]
    _, _, valid = P.sample_placements(tight, 4, torch.Generator().manual_seed(0))
    assert not bool(valid.any())
