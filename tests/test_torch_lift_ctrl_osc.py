"""Lift-Panda with OSC_POSITION, OSC_POSE with linear goal interpolation,
and OSC_POSE with absolute input in the world frame: the port's
rollout_batch (on the CPU the fused path's plain version, as the JAX gate
fuses these) against the JAX package's _rollout_impl from one JAX state
carried across (the interpolation's start pose too), at
tests/test_torch_lift.py's bounds (tests/test_torch_lift_ctrl_joint.py's
harness); the fused and unfused paths, and the fused and unfused planning
returns, agree under interpolation on the CPU (1e-6, as
tests/test_torch_lift.py holds them); and the fused gate decides as the
JAX gate on Lift, Door and Sawyer-Lift for every arm controller."""

import numpy as np
import pytest
import torch

from tests.test_torch_lift_ctrl_joint import B, carry, check_steps, lift_pair
from tests.test_torch_door import one_thread  # noqa: F401  (an autouse fixture: one torch thread)

OSC_CONFIGS = {
    "OSC_POSITION": "OSC_POSITION",
    "linear": {"right": {"type": "OSC_POSE", "interpolation": "linear"}},
    "absolute world": {"right": {"type": "OSC_POSE", "input_type": "absolute", "input_ref_frame": "world"}},
}


@pytest.mark.parametrize("name", list(OSC_CONFIGS))
def test_policy_steps_match_jax(name):
    ps = check_steps(name, OSC_CONFIGS[name], absolute=name == "absolute world")
    st = ps.ctrl.arm["right"]
    assert st.start_pos is not None and st.start_pos.shape == st.goal_pos.shape


@pytest.mark.parametrize("name", list(OSC_CONFIGS))
def test_action_space_and_gate_match_jax(name):
    """action_dim (OSC_POSITION: 3 + the gripper) and action_limits as the
    JAX env's; both gates fuse the world."""
    from robosuite_tpu.ops import pallas_substep as JPS

    from robosuite_tpu_torch.ops import substep

    jenv, penv, _, _ = lift_pair(name, OSC_CONFIGS[name])
    assert penv.action_dim == jenv.action_dim == (4 if name == "OSC_POSITION" else 7)
    for p, j in zip(penv.action_spec, jenv.action_spec):
        np.testing.assert_array_equal(p, np.asarray(j))
    JPS.extract_spec(jenv, jenv.model)
    spec = substep.extract_spec(penv, penv.model)
    assert spec["ctrl_type"] == "osc" and spec["goal_width"] == 12
    assert penv._fused_for(penv.model) is not None


def test_interpolated_fused_and_unfused_paths_agree():
    """Under interpolation the fused path resolves a goal row a substep
    from the step's start poses, the unfused path the law's own goal at
    each substep's: one policy step and the planning return (H=2 on the
    2-point planning model) agree on the CPU plain versions; and the ramp
    moves the goal row between the substeps of a step."""
    _, penv, _, js = lift_pair("linear", OSC_CONFIGS["linear"])
    ps = carry(js)
    rng = np.random.default_rng(3)
    a = torch.as_tensor(np.clip(0.5 * rng.standard_normal((B, penv.action_dim)), -1, 1).astype(np.float32))
    plan = penv.model.replace(timestep=0.025, solver_iters=10, pair_points_cap=2)
    seqs = torch.as_tensor(np.clip(0.5 * rng.standard_normal((B, 2, penv.action_dim)), -1, 1).astype(np.float32))
    disc = torch.ones(2)
    s1, r1 = penv.rollout_batch(ps, a)
    ret1 = penv.make_plan_return(plan, 2)(ps, seqs, disc)
    penv._disable_fused = True
    try:
        s2, r2 = penv.rollout_batch(ps, a)
        ret2 = penv.make_plan_return(plan, 2)(ps, seqs, disc)
    finally:
        penv._disable_fused = False
    torch.testing.assert_close(s1.physics.qpos, s2.physics.qpos, rtol=0, atol=1e-6)
    torch.testing.assert_close(s1.physics.qvel, s2.physics.qvel, rtol=0, atol=1e-6)
    torch.testing.assert_close(r1, r2, rtol=0, atol=1e-6)
    torch.testing.assert_close(ret1, ret2, rtol=0, atol=1e-6)

    from robosuite_tpu_torch.physics import engine

    robot = penv.robots[0]
    kin, M, bias = engine.forward_products(penv.model, ps.physics.qpos, ps.physics.qvel)
    ctrl = penv._set_goals(kin, M, bias, ps.physics.qpos, ps.physics.qvel, ps.ctrl, a)
    goal_at = penv._fused_goals(robot, "right", ctrl, kin)
    rows = [goal_at(k)[0] for k in range(penv.n_substeps)]
    steps = robot.arm_cfg["right"].interp_steps
    assert float((rows[0] - rows[steps - 1]).abs().max()) > 1e-4
    assert all(torch.equal(rows[k], rows[steps - 1]) for k in range(steps, penv.n_substeps))
    torch.testing.assert_close(rows[-1], penv._fused_goal_fn(robot, "right", ctrl, kin)[0], rtol=0, atol=1e-6)


def test_fused_gate_matches_jax_on_door_and_sawyer():
    """Door-Panda with absolute world-frame OSC fuses in both packages;
    Sawyer-Lift (its rows compact) refuses every arm controller in both;
    Lift-Panda refuses IK_POSE, JOINT_VELOCITY and JOINT_TORQUE and fuses
    every OSC setting. The arm configs are swapped on one env a world."""
    import robosuite_tpu
    import robosuite_tpu_torch
    from robosuite_tpu.controllers import factory as jfactory
    from robosuite_tpu.ops import pallas_substep as JPS

    from robosuite_tpu_torch.controllers import factory
    from robosuite_tpu_torch.ops import substep

    world = {"type": "OSC_POSE", "input_type": "absolute", "input_ref_frame": "world"}
    jdoor = robosuite_tpu.make("Door", robots="Panda", seed=0, controller_configs={"right": dict(world)})
    pdoor = robosuite_tpu_torch.make("Door", robots="Panda", seed=0, device="cpu",
                                     controller_configs={"right": dict(world)})
    JPS.extract_spec(jdoor, jdoor.model)
    assert substep.extract_spec(pdoor, pdoor.model)["ctrl_type"] == "osc"

    settings = [("OSC_POSE", {}), ("OSC_POSITION", {}), ("OSC_POSE", dict(interpolation="linear")),
                ("OSC_POSE", dict(input_type="absolute", input_ref_frame="world")), ("IK_POSE", {}),
                ("JOINT_VELOCITY", {}), ("JOINT_TORQUE", {}), ("JOINT_POSITION", {})]
    for robot in ("Panda", "Sawyer"):
        jenv = robosuite_tpu.make("Lift", robots=robot)
        penv = robosuite_tpu_torch.make("Lift", robots=robot, device="cpu")
        for t, kw in settings:
            jenv.robots[0].arm_cfg = {"right": jfactory.arm_controller_config(t, **kw)}
            penv.robots[0].arm_cfg = {"right": factory.arm_controller_config(t, **kw)}
            try:
                JPS.extract_spec(jenv, jenv.model)
                jax_fuses = True
            except JPS.UnsupportedFused:
                jax_fuses = False
            try:
                substep.extract_spec(penv, penv.model)
                port_fuses = True
            except substep.UnsupportedFused:
                port_fuses = False
            assert port_fuses == jax_fuses == (robot == "Panda" and t in ("OSC_POSE", "OSC_POSITION",
                                                                             "JOINT_POSITION")), (robot, t, kw)


SAWYER_CONFIGS = {"IK_POSE": "IK_POSE", "JOINT_VELOCITY": "JOINT_VELOCITY", "JOINT_TORQUE": "JOINT_TORQUE",
                  **OSC_CONFIGS}


@pytest.mark.parametrize("name", list(SAWYER_CONFIGS))
def test_sawyer_lift_builds_and_steps(name):
    """Lift with the Sawyer and each new arm setting builds with the JAX
    env's action_dim and action_limits, and a reset and two step_batch
    policy steps give finite observations on the unfused path (the rows
    compact, so both gates refuse the world)."""
    import copy

    import robosuite_tpu
    import robosuite_tpu_torch

    c = SAWYER_CONFIGS[name]
    jenv = robosuite_tpu.make("Lift", robots="Sawyer", controller_configs=copy.deepcopy(c))
    penv = robosuite_tpu_torch.make("Lift", robots="Sawyer", device="cpu", controller_configs=copy.deepcopy(c))
    assert penv.action_dim == jenv.action_dim
    for p, j in zip(penv.action_spec, jenv.action_spec):
        np.testing.assert_array_equal(p, np.asarray(j))
    assert penv._fused_for(penv.model) is None
    s, obs = penv.reset_batch(B, torch.Generator().manual_seed(0))
    a = torch.clamp(0.3 * torch.randn(B, penv.action_dim, generator=torch.Generator().manual_seed(1)), -1.0, 1.0)
    if name == "absolute world":
        a[:, :3] = obs["robot0_eef_pos"]
    for _ in range(2):
        s, obs, r, done, _ = penv.step_batch(s, a)
    assert all(bool(torch.isfinite(v.float()).all()) for v in obs.values()) and bool(torch.isfinite(r).all())
