"""The legged robots in Lift, SpotWithArm (the Spot arm on the legged Spot
body: a free root joint beside the cube's, 12 leg joints on Spot's raw
position servo) and SpotWithArmFloating (the de-legged body on planar
joints), in the port against the JAX package on the CPU (one torch
thread):

  * the worlds build as the JAX package's (test_torch_mobile_robots.
    hold_world: leaves at 1e-6, static fields, the LeggedRobot runtime,
    its splits and part indices), fit K1's and K2's maxima, and the fused
    gate refuses them ("non-fixed-base robot");
  * the legs' part: Spot's leg_servo (kp 500, kv 40) as a raw PD, delta
    commands anchored to the standing posture (0, 0.9, -1.8) x 4 (the
    JAX package's documented deviation from robosuite), is_legs_actuated,
    num_leg_joints, legs_init_qpos; none on the floating body;
  * _initial_qpos sets the leg base's standing posture;
  * physics/kinematics.body_velocities against the JAX function (1e-5 of
    the largest) on its tree;
  * a zero action holds the stance: 20 policy steps of the port's own
    step_batch keep the base's centre above 0.35 m and end it above 0.5 m,
    within 0.2 m of its start (the JAX package's
    tests/test_legged_robot.py::test_spot_stands_under_leg_stack bounds);
  * one step_batch policy step of SpotWithArm (SpotWithArmFloating's:
    tests/test_torch_legged_robots_step.py) from an injected JAX state
    (test_torch_mobile_robots.hold_step: goals 1e-5, substeps at qpos
    1e-5 and qvel 1e-4, the observations and the reward at 1e-5): both
    free joints integrate as the JAX package's.
"""

import numpy as np
import pytest
import torch

from robosuite_tpu_torch.ops import contact_solve, substep as psub, tables
from robosuite_tpu_torch.physics import contact as C
from robosuite_tpu_torch.physics import kinematics
from tests.test_torch_mobile_robots import REF_SPLITS, build_both, hold_step, hold_world

SPLITS = dict(REF_SPLITS, SpotWithArm={"right": (0, 6), "legs": (6, 18), "right_gripper": (18, 19)})
STANCE = [0.0, 0.9, -1.8] * 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("robot", ["SpotWithArm", "SpotWithArmFloating"])
def test_world_builds_as_jax_with_the_leg_stack(robot):
    jenv, penv = build_both(robot)
    hold_world(jenv, penv)
    r = penv.robots[0]
    assert r.action_split_indexes() == SPLITS[robot]
    pm = penv.model
    assert tables.check_model(pm, contacts=False) == 0
    tables.pack(pm)
    contact_solve.check_sizes(pm.nv, C.contact_warmstart_dim(pm) // 3)
    with pytest.raises(psub.UnsupportedFused, match="non-fixed-base robot"):
        psub.extract_spec(penv, pm)
    jr = jenv.robots[0]
    assert r.is_legs_actuated == jr.is_legs_actuated and r.num_leg_joints == jr.num_leg_joints
    if robot == "SpotWithArmFloating":
        assert r.legs_init_qpos is None and jr.legs_init_qpos is None and "legs" not in r.part_cfg
        assert pm.jnt_type.count(0) == 1  # the cube's free joint alone
        return
    assert pm.jnt_type.count(0) == 2 and pm.jnt_type[0] == 0  # Spot's root, then the cube's
    cfg = r.part_cfg["legs"]
    assert (cfg.raw_pd, cfg.kp, cfg.kd, cfg.input_type) == (True, 500.0, 40.0, "absolute")
    assert r.is_legs_actuated and r.num_leg_joints == 12
    np.testing.assert_array_equal(r.legs_init_qpos, np.float32(STANCE))
    np.testing.assert_array_equal(r._legs_anchor.numpy(), np.asarray(jr._legs_anchor))


def test_initial_qpos_sets_the_standing_posture():
    import robosuite_tpu_torch

    env = robosuite_tpu_torch.make("Lift", robots="SpotWithArm", device="cpu", seed=0)
    r = env.robots[0]
    q = env._initial_qpos(3, torch.Generator().manual_seed(0))
    assert torch.equal(q[:, r.part_qpos_idx["legs"]], torch.tensor(STANCE).expand(3, 12))


def test_spot_stands_under_a_zero_action():
    import robosuite_tpu_torch

    env = robosuite_tpu_torch.make("Lift", robots="SpotWithArm", device="cpu", seed=0)
    r = env.robots[0]
    s, _ = env.reset_batch(2, torch.Generator().manual_seed(0))
    site = env.model.site_name2id(r.rm.base.center_site)
    z0 = kinematics.fk(env.model, s.physics.qpos).site_xpos[:, site, 2]
    a = torch.zeros(2, env.action_dim)
    zs = []
    for _ in range(20):  # 1 s
        s, *_ = env.step_batch(s, a)
        zs.append(kinematics.fk(env.model, s.physics.qpos).site_xpos[:, site, 2])
    zs = torch.stack(zs)
    assert bool(torch.isfinite(s.physics.qpos).all())
    assert float(zs.min()) > 0.35 and float(zs[-1].min()) > 0.5 and float((z0 - zs[-1]).max()) < 0.2, zs[:, 0]


def test_spotwitharm_step_matches_jax():
    hold_step("SpotWithArm", observations=True)


def test_body_velocities_match_jax():
    """physics/kinematics.body_velocities (each body's world-frame spatial
    velocity) against the JAX function at 1e-5 of max(1, the largest), on
    SpotWithArm's tree (its free root moving) at seeded joints and
    velocities."""
    import jax
    import jax.numpy as jnp
    from robosuite_tpu.physics import kinematics as jkin

    jenv, penv = build_both("SpotWithArm")
    pm = penv.model
    rng = np.random.default_rng(7)
    s, _ = penv.reset_batch(3, torch.Generator().manual_seed(7))
    q = s.physics.qpos
    qd = torch.tensor(rng.standard_normal((3, pm.nv)).astype(np.float32))
    ang, lin = kinematics.body_velocities(pm, kinematics.fk(pm, q), qd)
    jang, jlin = jax.jit(jax.vmap(lambda a, b: jkin.body_velocities(jenv.model, jkin.fk(jenv.model, a), b)))(
        jnp.asarray(q.numpy()), jnp.asarray(qd.numpy()))
    assert ang.shape == lin.shape == (3, pm.nbody, 3)
    for got, want in ((ang, jang), (lin, jlin)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * max(1.0, float(np.abs(want).max())))
