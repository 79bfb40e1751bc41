"""The robots that need no new physics, SpotArm, PandaDexRH, PandaDexLH and
the bimanual Baxter, with their grippers (BDGripper, the Inspire hands)
and mounts (RethinkMinimalMount, NullMount): the port's worlds and robot
metadata against the JAX package's, on the CPU.

  * each world (Lift, Stack and Door with the new robots, the four
    two-arm envs with one Baxter, the "single-robot" configuration, and
    PickPlaceCan with Baxter and PandaDexRH): every compiled leaf 1e-7 and
    every static field, with the construction seed fixed; the sizes, the
    row layout and compaction, the action width and bounds;
  * the robot, gripper and mount metadata: init_qpos, the arms' joints,
    the eef bodies and sites, the placement offsets, the mounts' offsets
    and radii, the grippers' dof, speed, important geoms and action
    indices; the per-robot controller JSON (PandaDexRH / LH share
    default_panda_dex.json) and the arm configs it gives;
  * the gripper goal (robots/robot.py _gripper_goal) against the JAX
    robot's on random actions: an Inspire hand's 6-wide action mapped
    straight onto its 12 actuators, clipped; BDGripper's binary ramp;
  * the fused gate (ops/substep.extract_spec) decides each world as the
    JAX gate does, refusing Baxter as multi-arm; K3's table takes the 12
    gripper actuators of an Inspire hand and SpotArm's 6 arm dofs;
    tables.check_model takes PickPlaceCan with Baxter or PandaDexRH (nq
    46-47, nv 42-43: the maxima raised to nq 48, nv 44) and refuses one
    past them with a ValueError naming the maximum;
  * a one-arm robot in a two-arm env's "single-robot" configuration
    raises ValueError (robosuite's configuration check).

One policy step of four of these worlds is held in
tests/test_torch_robots_step.py.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from robosuite_tpu_torch.models import model as PM
from robosuite_tpu_torch.ops import substep, tables
from robosuite_tpu_torch.physics import contact as C

# (env, robot) -> (nq, nv, nbody, ngeom, nsite, nu, npair): the sizes
# measured in the JAX package
WORLDS = {
    ("Lift", "SpotArm"): (14, 13, 23, 54, 9, 7, 5),
    ("Lift", "PandaDexRH"): (26, 25, 40, 108, 20, 19, 5),
    ("Lift", "PandaDexLH"): (26, 25, 40, 108, 20, 19, 5),
    ("Stack", "PandaDexLH"): (33, 31, 41, 110, 21, 19, 11),
    ("Stack", "SpotArm"): (21, 19, 24, 56, 10, 7, 11),
    ("Door", "PandaDexRH"): (21, 21, 44, 113, 24, 19, 35),
    ("Door", "SpotArm"): (9, 9, 27, 59, 13, 7, 35),
    ("Lift", "Baxter"): (25, 24, 44, 118, 17, 18, 351),
    ("TwoArmLift", "Baxter"): (25, 24, 44, 127, 20, 18, 761),
    ("TwoArmPegInHole", "Baxter"): (14, 14, 37, 77, 20, 14, 257),
    ("TwoArmHandover", "Baxter"): (25, 24, 44, 118, 18, 18, 392),
    ("TwoArmTransport", "Baxter"): (39, 36, 50, 127, 24, 18, 1179),
    ("PickPlaceCan", "Baxter"): (46, 42, 48, 120, 19, 18, 840),
    ("PickPlaceCan", "PandaDexRH"): (47, 43, 44, 110, 22, 19, 62),
}
FUSED = {("Lift", "SpotArm"), ("Lift", "PandaDexRH"), ("Lift", "PandaDexLH"), ("Stack", "PandaDexLH"),
         ("Stack", "SpotArm"), ("Door", "PandaDexRH"), ("Door", "SpotArm")}
ROBOTS = ("SpotArm", "PandaDexRH", "PandaDexLH", "Baxter")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_ENVS = {}


def envs(name, robot):
    """(the JAX env, the port's CPU env), made once per module; Lift and
    Door draw their cube size and door pose from seed 0."""
    if (name, robot) not in _ENVS:
        import robosuite_tpu
        import robosuite_tpu_torch

        kw = dict(robots=robot, reward_shaping=True, **({"seed": 0} if name in ("Lift", "Door") else {}))
        _ENVS[name, robot] = robosuite_tpu.make(name, **kw), robosuite_tpu_torch.make(name, device="cpu", **kw)
    return _ENVS[name, robot]


def _static(v):
    return tuple(v) if isinstance(v, (list, tuple)) else v


@pytest.mark.parametrize("name,robot", list(WORLDS), ids=[f"{n}-{r}" for n, r in WORLDS])
def test_world_matches_jax(name, robot):
    """Every compiled leaf 1e-7 and every static field of the world against
    the JAX package's; the sizes, the pairs and their order, the row
    layout and compaction, the action width and its bounds, each robot's
    arms and their joints, actuators, eef sites and gripper actuators."""
    from robosuite_tpu.physics import contact as JC

    jenv, penv = envs(name, robot)
    jm, pm = jenv.model, penv.model
    for field in PM.LEAVES:
        a, b = np.asarray(getattr(jm, field), dtype=np.float64), getattr(pm, field).numpy().astype(np.float64)
        assert a.shape == b.shape, field
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-7, err_msg=field)
    for field in PM.STATIC:
        assert _static(getattr(pm, field)) == _static(getattr(jm, field)), field
    sizes = ("nq", "nv", "nbody", "ngeom", "nsite", "nu", "npair")
    assert tuple(getattr(pm, n) for n in sizes) == WORLDS[name, robot]
    assert [(pm.pair_geom1[k], pm.pair_geom2[k]) for k in range(pm.npair)] == [
        (int(jm.pair_geom1[k]), int(jm.pair_geom2[k])) for k in range(jm.npair)]
    assert C.contact_row_layout(pm) == JC.contact_row_layout(jm)
    assert C.uses_row_compaction(pm) == JC.uses_row_compaction(jm) == (robot == "Baxter" or name == "PickPlaceCan")
    null_grippers = name == "TwoArmPegInHole"  # no gripper action
    assert penv.action_dim == jenv.action_dim == {"SpotArm": 7, "Baxter": 12 if null_grippers else 14}.get(robot, 12)
    for got, want in zip(penv.action_spec, jenv.action_spec):
        np.testing.assert_array_equal(got, want)
    for pr, jr in zip(penv.robots, jenv.robots):
        assert pr.arms == jr.arms == (["right", "left"] if robot == "Baxter" else ["right"])
        for arm in pr.arms:
            for attr in ("arm_qpos_idx", "arm_qvel_idx", "arm_actuator_ids", "gripper_joint_qpos_idx",
                         "gripper_actuator_ids"):
                np.testing.assert_array_equal(getattr(pr, attr)[arm], getattr(jr, attr)[arm], err_msg=attr)
            assert pr.eef_site_id[arm] == jr.eef_site_id[arm] and pr.center_site_id[arm] == jr.center_site_id[arm]
            np.testing.assert_array_equal(pr.initial_joint[arm].numpy(), np.asarray(jr.initial_joint[arm]))
            for i in range(2):
                np.testing.assert_array_equal(pr.torque_limits[arm][i], jr.torque_limits[arm][i])
        np.testing.assert_array_equal(pr.init_qpos_idx, jr.init_qpos_idx)
        assert pr.action_split_indexes() == jr.action_split_indexes()
    if hasattr(jenv, "eef_sites"):  # the two-arm envs: the endpoints, right arm then left
        assert penv.eef_sites == jenv.eef_sites
        assert penv.env_configuration == jenv.env_configuration == "single-robot"


@pytest.mark.parametrize("robot", ROBOTS)
def test_robot_metadata_matches_jax(robot):
    """The robot model's metadata against the JAX package's: init_qpos, the
    card's joints and each arm's, the eef bodies, the placement offsets at
    three table lengths, top_offset, horizontal_radius, arm_type, the
    default base and grippers, the gripper mount offsets; and the mount's
    offsets and radius."""
    import robosuite_tpu.models.robots as JR

    import robosuite_tpu_torch.models.robots as PR

    p, j = PR.create_robot(robot, idn=0), JR.create_robot(robot, idn=0)
    np.testing.assert_array_equal(p.init_qpos, j.init_qpos)
    assert p.card_joint_names == j.card_joint_names
    assert p.arm_joint_names == j.arm_joint_names and p.eef_name == j.eef_name
    assert list(p.arm_joint_names) == p.arms == j.arms
    for key in ("bins", "empty"):
        assert tuple(p.base_xpos_offset[key]) == tuple(j.base_xpos_offset[key])
    for length in (0.8, 1.2, 1.4):
        assert tuple(p.base_xpos_offset["table"](length)) == tuple(j.base_xpos_offset["table"](length))
    np.testing.assert_array_equal(p.top_offset, j.top_offset)
    assert (p.horizontal_radius, p.arm_type) == (j.horizontal_radius, j.arm_type)
    assert (p.default_base, p.default_gripper) == (j.default_base, j.default_gripper)
    assert p.gripper_mount_pos_offset == j.gripper_mount_pos_offset
    assert p.gripper_mount_quat_offset == j.gripper_mount_quat_offset


@pytest.mark.parametrize("base", ["RethinkMount", "RethinkMinimalMount", "NullMount"])
def test_mount_offsets_match_jax(base):
    import robosuite_tpu.models.bases as JB

    import robosuite_tpu_torch.models.bases as PB

    p, j = PB.robot_base_factory(base, idn=1), JB.robot_base_factory(base, idn=1)
    for attr in ("top_offset", "bottom_offset"):
        np.testing.assert_array_equal(getattr(p, attr), getattr(j, attr), err_msg=attr)
    assert p.horizontal_radius == j.horizontal_radius and p.naming_prefix == j.naming_prefix
    assert [b.name for b in p.root_subtree().walk()] == [b.name for b in j.root_subtree().walk()]
    assert type(PB.robot_base_factory(None)).__name__ == "NullMount"


@pytest.mark.parametrize("gripper", ["BDGripper", "InspireLeftHand", "InspireRightHand"])
def test_gripper_metadata_matches_jax(gripper):
    import robosuite_tpu.models.grippers as JG

    import robosuite_tpu_torch.models.grippers as PG

    p, j = PG.gripper_factory(gripper, idn=0, arm="right"), JG.gripper_factory(gripper, idn=0, arm="right")
    assert (p.dof, p.speed, p.naming_prefix) == (j.dof, j.speed, j.naming_prefix)
    np.testing.assert_array_equal(p.init_qpos, j.init_qpos)
    assert p.important_geoms == j.important_geoms and p.important_sites == j.important_sites
    assert p.joint_names == j.joint_names and p.actuator_names == j.actuator_names
    np.testing.assert_array_equal(p.format_action_direction(), j.format_action_direction())
    pi, ji = p.format_action_indices(), j.format_action_indices()
    assert (pi is None) == (ji is None) == (gripper == "BDGripper")
    if pi is not None:
        np.testing.assert_array_equal(pi, ji)
        assert len(pi) == len(p.actuator_names) == 12 and int(pi.max()) == p.dof - 1


def test_controller_configs_match_jax():
    """PandaDexRH / LH read default_panda_dex.json, SpotArm
    default_spotarm.json, Baxter default_baxter.json (one OSC_POSE part
    per arm): the port's arm configs equal the JAX package's."""
    from robosuite_tpu.controllers.factory import load_composite_controller_config as jload
    from robosuite_tpu.controllers.factory import robot_config_name as jname

    from robosuite_tpu_torch.controllers.factory import load_composite_controller_config, robot_config_name

    want = {"PandaDexRH": "panda_dex", "PandaDexLH": "panda_dex", "SpotArm": "spotarm", "Baxter": "baxter"}
    for robot, stem in want.items():
        assert robot_config_name(robot) == jname(robot) == stem
        arms = ("right", "left") if robot == "Baxter" else ("right",)
        got = load_composite_controller_config(None, robot=robot, arms=arms)
        ref = jload(None, robot=robot, arms=arms)
        assert set(got) == set(arms)
        for arm in arms:
            for field, v in vars(got[arm]).items():
                w = getattr(ref[arm], field)
                assert (tuple(v) if isinstance(v, (list, tuple)) else v) == \
                    (tuple(w) if isinstance(w, (list, tuple)) else w), (robot, arm, field)


@pytest.mark.parametrize("robot", ["PandaDexRH", "SpotArm", "Baxter"])
def test_gripper_goal_matches_jax(robot):
    """_gripper_goal against the JAX robot's, scenario by scenario, on
    seeded random actions past [-1, 1] and a random current command: the
    Inspire hand's 6-wide action mapped onto its 12 actuators and clipped
    (the current command unused), BDGripper's and the Rethink grippers'
    binary ramp (speed times the action's sign, clipped), each arm of
    Baxter's on its own columns; exact."""
    jenv, penv = envs("Lift", robot)
    rng = np.random.default_rng(5)
    for pr, jr in zip(penv.robots, jenv.robots):
        idx = pr.action_split_indexes()
        for arm in pr.arms:
            gs, ge = idx[f"{arm}_gripper"]
            n_act = len(pr.gripper_actuator_ids[arm])
            a = rng.uniform(-1.5, 1.5, (8, penv.action_dim)).astype(np.float32)
            a[:2, gs:ge] = 0.0  # sign 0: the ramp holds
            cur = rng.uniform(-1.0, 1.0, (8, n_act)).astype(np.float32)
            got = pr._gripper_goal(arm, torch.as_tensor(cur), torch.as_tensor(a[:, gs:ge])).numpy()
            assert got.shape == (8, n_act) == (8, {"PandaDexRH": 12, "SpotArm": 1, "Baxter": 2}[robot])
            for b in range(8):
                want = jr._gripper_goal(arm, jnp.asarray(cur[b]), jnp.asarray(a[b, gs:ge]), jnp.float32)
                np.testing.assert_array_equal(got[b], np.asarray(want))


@pytest.mark.parametrize("name,robot", list(WORLDS), ids=[f"{n}-{r}" for n, r in WORLDS])
def test_fused_gate_follows_jax(name, robot):
    """extract_spec admits the worlds the JAX gate admits (SpotArm's and
    the PandaDex hands' on Lift, Stack and Door) and refuses the others:
    Baxter as multi-arm, as the JAX gate does, and PickPlaceCan-PandaDexRH
    (its row compaction and its hull pairs). On an admitted world K3's
    table takes the arm (6 or 7 dofs) and the gripper actuators (1, or 12
    for an Inspire hand), and the env has a fused wrapper."""
    from robosuite_tpu.ops import pallas_substep as JPS

    jenv, penv = envs(name, robot)
    try:
        JPS.extract_spec(jenv, jenv.model)
        jax_fuses = True
    except JPS.UnsupportedFused as e:
        jax_fuses = False
        if robot == "Baxter":
            assert "multi-arm" in str(e)
    assert jax_fuses == ((name, robot) in FUSED)
    if not jax_fuses:
        with pytest.raises(substep.UnsupportedFused, match="multi-arm" if robot == "Baxter" else None):
            substep.extract_spec(penv, penv.model)
        assert penv._fused_for(penv.model) is None
        return
    spec = substep.extract_spec(penv, penv.model)
    t = tables.fill(penv.model, arm=spec)
    assert (t.na, t.ngrip) == (6 if robot == "SpotArm" else 7, 1 if robot == "SpotArm" else 12)
    assert list(t.grip_act)[:t.ngrip] == [int(a) for a in penv.robots[0].gripper_actuator_ids["right"]]
    assert list(t.arm_qv)[:t.na] == [int(i) for i in penv.robots[0].arm_qvel_idx["right"]]
    assert penv._fused_for(penv.model) is not None


def test_kernel_maxima_take_twelve_gripper_actuators_and_refuse_pickplace():
    """MAXGR is 12 (csrc/common.cuh RS_MAXGR): a 13th gripper actuator is
    refused; K1's table (no contact part) takes every Baxter world, and
    PickPlaceCan with Baxter (nq 46, nv 42) and with PandaDexRH (nq 47, nv
    43) since the maxima were raised (nq 48, nv 44); PickPlaceCan with one
    qpos or dof past them is refused with a ValueError naming the maximum,
    so it never reaches a kernel on the card."""
    import os

    src = open(os.path.join(os.path.dirname(tables.__file__), "..", "csrc", "common.cuh")).read()
    assert "#define RS_MAXGR 12 " in src and tables.MAXGR == 12
    _, penv = envs("Lift", "PandaDexRH")
    spec = dict(substep.extract_spec(penv, penv.model))
    spec["grip_actuators"] = spec["grip_actuators"] + [spec["grip_actuators"][0]]
    with pytest.raises(ValueError, match="maxima"):
        tables.fill(penv.model, arm=spec)
    for name in ("Lift", "TwoArmLift", "TwoArmTransport"):
        assert tables.check_model(envs(name, "Baxter")[1].model, contacts=False) == 0
    for robot in ("Baxter", "PandaDexRH"):
        m = envs("PickPlaceCan", robot)[1].model
        assert tables.check_model(m, contacts=False) == 0
        for field, cap in (("nq", tables.MAXQ), ("nv", tables.MAXV)):
            big = copy.copy(m)
            setattr(big, field, cap + 1)
            with pytest.raises(ValueError, match=f"{field}={cap + 1} exceeds the kernels' maximum {cap}"):
                tables.check_model(big, contacts=False)


def test_single_robot_configuration_takes_a_bimanual_robot_only():
    """A one-arm robot in a two-arm env's single-robot configuration raises
    ValueError naming the configuration; Baxter there places its base at
    its own table offset (robosuite two_arm_lift.py:302-326)."""
    import robosuite_tpu_torch

    for name in ("TwoArmLift", "TwoArmPegInHole", "TwoArmHandover", "TwoArmTransport"):
        with pytest.raises(ValueError, match="single-robot"):
            robosuite_tpu_torch.make(name, robots="Panda", device="cpu")
    _, penv = envs("TwoArmLift", "Baxter")
    rm = penv.robot_models[0]
    np.testing.assert_allclose(rm.root_subtree().pos, np.array([-0.26 - 0.4, 0.0, 0.0]) - rm.bottom_offset)
