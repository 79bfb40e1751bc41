"""GR1 and its three variants (GR1FixedLowerBody, GR1FloatingBody,
GR1ArmsOnly) in Lift, in the port against the JAX package on the CPU (one
torch thread):

  * each world builds as the JAX one (test_torch_mobile_robots.hold_world:
    every compiled leaf at 1e-6, every static field equal, the runtime's
    class, action split and part indices), with the JAX robot's
    is_legs_actuated, num_leg_joints and legs_init_qpos (GR1's legs
    anchored to the card's reset posture, which no leg base gives), and
    the fused gate refuses it ("non-fixed-base robot"), so it runs
    unfused on the card;
  * the spec surgery (_remove_joint_actuation, _remove_free_joint): the
    joints, actuators and card joints left, and init_qpos covering them;
  * the Fourier hands' metadata (dof, speed, init_qpos, the 6 -> 11
    format_action_indices, the fingerpad geoms, the actuators);
  * the whole-body IK problem of GR1, GR1FixedLowerBody (WHOLE_BODY_MINK_IK
    run as WHOLE_BODY_IK) and GR1ArmsOnly as the JAX one builds it (the
    torso first, then the arms; the nullspace gains by joint suffix; the
    torso mask; the posture);
  * one policy-rate set_goals of GR1 and GR1FixedLowerBody from an
    injected JAX state (convert.state_from_numpy: the arms', torso's,
    head's and legs' JointPosState carried across exactly), the goals at
    1e-5 of the JAX goals and the Fourier hands' commands exactly
    (GR1ArmsOnly's and GR1FloatingBody's: tests/test_torch_gr1_step.py,
    tests/test_torch_gr1_floating_step.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from robosuite_tpu_torch import convert
from robosuite_tpu_torch.ops import substep as psub
from robosuite_tpu_torch.ops import tables
from robosuite_tpu_torch.physics import engine
from tests.test_torch_mobile_robots import build_both, hold_ctrl, hold_world, setup

ROBOTS = ("GR1", "GR1FixedLowerBody", "GR1FloatingBody", "GR1ArmsOnly")
# (nq, nv, nbody, njnt, nsite, nu, npair, action_dim) as the JAX package builds them
SIZES = {"GR1": (61, 60, 92, 55, 51, 54, 558, 24), "GR1FixedLowerBody": (49, 48, 92, 43, 51, 42, 410, 24),
         "GR1FloatingBody": (52, 51, 92, 46, 51, 45, 444, 34), "GR1ArmsOnly": (43, 42, 92, 37, 51, 36, 311, 24)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_BOTH = {}


def both(robot):
    if robot not in _BOTH:
        _BOTH[robot] = build_both(robot)
    return _BOTH[robot]


@pytest.mark.parametrize("robot", ROBOTS)
def test_world_builds_as_jax(robot):
    jenv, penv = both(robot)
    hold_world(jenv, penv)
    pm, jr, pr = penv.model, jenv.robots[0], penv.robots[0]
    assert (pm.nq, pm.nv, pm.nbody, pm.njnt, pm.nsite, pm.nu, pm.npair, penv.action_dim) == SIZES[robot]
    assert type(pr).__name__ == "LeggedRobot"
    assert pr.is_legs_actuated == jr.is_legs_actuated == (robot == "GR1")
    assert pr.num_leg_joints == jr.num_leg_joints == (12 if robot == "GR1" else 0)
    if robot == "GR1":
        np.testing.assert_array_equal(pr.legs_init_qpos, jr.legs_init_qpos)
        np.testing.assert_array_equal(pr._legs_anchor.numpy(), np.asarray(jr._legs_anchor))
    else:
        assert pr.legs_init_qpos is None and jr.legs_init_qpos is None
    # WHOLE_BODY_MINK_IK runs as WHOLE_BODY_IK in both (the JAX robot keeps the name)
    assert pr.composite_type == {"WHOLE_BODY_MINK_IK": "WHOLE_BODY_IK"}.get(jr._composite_type, jr._composite_type)
    assert (pr.wbik_spec is None) == (jr._wbik_spec is None) == (robot == "GR1FloatingBody")
    assert tables.check_model(pm, contacts=False) == 0
    with pytest.raises(psub.UnsupportedFused, match="non-fixed-base robot"):
        psub.extract_spec(penv, pm)
    assert penv._fused_for(pm) is None


def test_legs_posture_from_the_card():
    """The second branch of legs_init_qpos (no leg base: the card carries
    the legs), in both packages on the same runtime fields: each leg
    joint's entry of init_qpos where init_qpos covers the card's joints,
    and qpos0 where it does not."""
    from types import SimpleNamespace

    from robosuite_tpu.robots.robot import LeggedRobot as JLegged
    from robosuite_tpu_torch.robots.robot import LeggedRobot

    _, penv = both("GR1")
    r = penv.robots[0]
    legs = r.part_qpos_idx["legs"]
    q0 = np.linspace(0.5, 1.0, penv.model.nq).astype(np.float32)
    for init_qpos, want in ((np.linspace(-0.3, 0.3, 32), np.linspace(-0.3, 0.3, 32)[20:]), (np.zeros(5), q0[legs])):
        fake = SimpleNamespace(rm=SimpleNamespace(base=SimpleNamespace(leg_joints=[], init_qpos=np.array([])),
                                                  init_qpos=init_qpos),
                               num_leg_joints=12, init_qpos_idx=r.init_qpos_idx, part_qpos_idx=r.part_qpos_idx,
                               model=SimpleNamespace(qpos0=torch.tensor(q0)))
        got = LeggedRobot.legs_init_qpos.fget(fake)
        np.testing.assert_array_equal(got, want.astype(np.float32))
        fake.model = SimpleNamespace(qpos0=q0)
        np.testing.assert_array_equal(JLegged.legs_init_qpos.fget(fake), got)


@pytest.mark.parametrize("robot", ROBOTS[1:])
def test_spec_surgery_matches_jax(robot):
    from robosuite_tpu.models.robots import create_robot as jcreate
    from robosuite_tpu_torch.models.robots import create_robot

    jm, pm = jcreate(robot), create_robot(robot)
    assert pm._removed_joints == jm._removed_joints
    assert all(n in pm._removed_joints for n in ("l_leg_hip_roll", "r_leg_ankle_roll"))
    walk = lambda m: [(j.name, j.type) for b in m.root_subtree().walk() for j in b.joints]  # noqa: E731
    assert walk(pm) == walk(jm) and not any(t == "free" for _, t in walk(pm))
    assert [a.name for a in pm.actuators()] == [a.name for a in jm.actuators()]
    assert pm.card_joint_names == jm.card_joint_names and len(pm.init_qpos) == len(pm.card_joint_names)
    np.testing.assert_array_equal(pm.init_qpos, jm.init_qpos)
    for attr in ("legs_joints", "torso_joints", "head_joints", "arm_joint_names", "eef_name"):
        assert getattr(pm, attr) == getattr(jm, attr), attr


@pytest.mark.parametrize("name", ["FourierLeftHand", "FourierRightHand"])
def test_fourier_hand_matches_jax(name):
    from robosuite_tpu.models.grippers import gripper_factory as jfactory
    from robosuite_tpu_torch.models.grippers import gripper_factory

    jg, pg = jfactory(name, idn=0), gripper_factory(name, idn=0)
    assert (pg.dof, pg.speed) == (jg.dof, jg.speed) == (6, 0.15)
    np.testing.assert_array_equal(pg.init_qpos, jg.init_qpos)
    np.testing.assert_array_equal(pg.format_action_indices(), jg.format_action_indices())
    assert len(pg.format_action_indices()) == len(pg.actuator_names) == 11
    assert pg.important_geoms == jg.important_geoms and pg.important_sites == jg.important_sites
    assert pg.actuator_names == jg.actuator_names and pg.joint_names == jg.joint_names


@pytest.mark.parametrize("robot", ["GR1", "GR1FixedLowerBody", "GR1ArmsOnly"])
def test_wbik_problem_matches_jax(robot):
    jenv, penv = both(robot)
    jr, pr = jenv.robots[0], penv.robots[0]
    jw, pw = jr._wbik_build(), pr._wbik_build()
    assert dataclasses.asdict(pw["cfg"]) == dataclasses.asdict(jw["cfg"])
    assert pw["slices"] == jw["slices"]
    np.testing.assert_array_equal(pw["qp"].numpy(), jw["qpos_idx"])
    np.testing.assert_array_equal(pw["qv"].numpy(), jw["qvel_idx"])
    np.testing.assert_array_equal(pw["q0"].numpy(), np.asarray(jw["q0"]))
    torso = 0 if robot == "GR1ArmsOnly" else 3
    assert list(pw["slices"]) == (["torso"] if torso else []) + ["right", "left"]
    assert pw["cfg"].torso_mask == (1.0,) * torso + (0.0,) * 14
    if torso:  # the waist by its suffix: default_gr1.json's 100, 100, 500; the MINK posture weights' 10, 10, 200
        assert pw["cfg"].nullspace_gains[:3] == ((100.0, 100.0, 500.0) if robot == "GR1" else (10.0, 10.0, 200.0))


@pytest.mark.parametrize("robot", ["GR1", "GR1FixedLowerBody"])
def test_set_goals_matches_jax(robot):
    jenv, penv, flat, pieces = setup(robot)
    rng = np.random.default_rng(35)
    action = np.clip(0.5 * rng.standard_normal((2, penv.action_dim)), -1.0, 1.0).astype(np.float32)
    js, packed = pieces["start"](jnp.asarray(flat), jnp.asarray(action))
    ps = convert.state_from_numpy(convert.numpy_tree(js), device="cpu")
    hold_ctrl(ps.ctrl, jenv._unpack_ctrl(js.ctrl)[0], 0.0)
    parts = {"right", "left", "torso", "head"} | ({"legs"} if robot == "GR1" else set())
    assert set(ps.ctrl.arm) == parts
    q, qd = ps.physics.qpos, ps.physics.qvel
    kin, M, bias = engine.forward_products(penv.model, q, qd)
    ctrl = penv._set_goals(kin, M, bias, q, qd, ps.ctrl, penv._clip(torch.as_tensor(action)))
    hold_ctrl(ctrl, jenv._unpack_ctrl(packed)[0], 1e-5)
    # the whole-body solve moved the torso and the arms; the head and the
    # legs hold their goals; each hand's 11 commands from its 6 actions
    for part in ("head",) + (("legs",) if robot == "GR1" else ()):
        torch.testing.assert_close(ctrl.arm[part].goal_qpos, ps.ctrl.arm[part].goal_qpos, rtol=0, atol=0)
    assert not torch.equal(ctrl.arm["torso"].goal_qpos, ps.ctrl.arm["torso"].goal_qpos)
    idx = penv.robots[0].action_split_indexes()
    for arm in ("right", "left"):
        a = torch.clamp(torch.as_tensor(action)[:, slice(*idx[f"{arm}_gripper"])], -1, 1)
        torch.testing.assert_close(ctrl.gripper_action[arm], a[:, [0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5]], rtol=0, atol=0)
