"""Fixed tendons, tendon and `general` actuators in the port against the
JAX package, on the CPU (each on one torch thread):

  * the compiled tendon, equality and actuator leaves and static fields of
    Lift with UR5e, Kinova3, IIWA, Jaco and XArm7 equal the JAX package's
    (1e-7);
  * the tendon pendulum of the JAX package's tests/test_grippers.py (two
    hinges whose tendon L = 0.5 q1 + 0.5 q2 is pinned to 0 by a tendon
    equality, a torque on the first) stepped 100 substeps in both
    packages: qpos 1e-5, qvel 1e-4 (the step tests' tolerances), and the
    coupling holds (|q1 + q2| < 2e-3, the JAX test's bound). Its capsules
    are built with contype 0 in both packages (they never touch; the port
    has no capsule-capsule narrowphase), so both take the pairless,
    equality-only velocity update;
  * tendon_forces (spring, friction, range limits, damping) and
    actuator_forces (position servos, XArm7's `general` servo on its
    tendon) of each world at seeded states against the JAX functions
    (1e-5 of max(1, their largest));
  * the fused gate refuses the five worlds with the JAX gate's reasons,
    and K1's table (check_model without contacts) takes XArm7's `general`
    actuator, which K3's (with contacts) refuses;
  * the gripper goal of Lift-Jaco with the three-finger gripper and its
    dexterous variant (each finger ramped from its own action element)
    equals the JAX robot's;
  * the gripper tester (models/grippers/gripper_tester.py): XArm7's
    tendon-driven gripper grasps and lifts its box; the Rethink, Jaco and
    Robotiq three-finger dexterous, Robotiq 85 and 140 grippers run its
    75-substep phases with a finite state (the JAX package's
    tests/test_grippers.py:18-45).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robosuite_tpu_torch import convert
from robosuite_tpu_torch.models import model as PM
from robosuite_tpu_torch.ops import substep, tables
from robosuite_tpu_torch.physics import dynamics, engine
from robosuite_tpu_torch.physics.state import State

ROBOTS = ("UR5e", "Kinova3", "IIWA", "Jaco", "XArm7")
TENDON_LEAVES = ("ten_J", "ten_Jq", "ten_range", "ten_stiffness", "ten_springlength", "ten_frictionloss",
                 "ten_damping", "ten_length0", "eq_anchor", "eq_anchor2", "eq_polycoef", "eq_solref",
                 "actuator_gear", "actuator_ctrlrange", "actuator_forcerange", "actuator_gainprm", "actuator_biasprm",
                 "actuator_ctrllimited", "actuator_forcelimited", "qpos0", "body_mass")
TENDON_STATIC = ("nq", "nv", "nu", "ntendon", "tendon_names", "tendon_limited", "actuator_tenid", "actuator_jntid",
                 "actuator_kind", "neq", "eq_kind", "eq_obj1", "eq_obj2")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_ENVS = {}


def envs(robot):
    """(JAX env, port CPU env) of Lift with `robot`, made once."""
    if robot not in _ENVS:
        import robosuite_tpu
        import robosuite_tpu_torch

        kw = dict(robots=robot, reward_shaping=True, seed=0)
        _ENVS[robot] = robosuite_tpu.make("Lift", **kw), robosuite_tpu_torch.make("Lift", device="cpu", **kw)
    return _ENVS[robot]


@pytest.mark.parametrize("robot", ROBOTS)
def test_compiled_tendon_equality_and_actuator_leaves_match_jax(robot):
    jenv, penv = envs(robot)
    jm, pm = jenv.model, penv.model
    for name in TENDON_STATIC:
        assert tuple(np.atleast_1d(getattr(pm, name))) == tuple(np.atleast_1d(getattr(jm, name))), name
    for name in TENDON_LEAVES:
        want = np.asarray(getattr(jm, name), dtype=np.float32)
        got = getattr(pm, name).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7, err_msg=name)
    assert pm.ntendon == {"UR5e": 2, "Kinova3": 2, "IIWA": 4, "Jaco": 3, "XArm7": 1}[robot]
    assert pm.neq == {"UR5e": 0, "Kinova3": 0, "IIWA": 4, "Jaco": 3, "XArm7": 3}[robot]
    # the carried model is the compiled one
    carried = convert.model_from_numpy({n: np.asarray(getattr(jm, n)) for n in PM.LEAVES},
                                       {n: getattr(jm, n) for n in PM.STATIC}, device="cpu")
    for name in TENDON_LEAVES:
        torch.testing.assert_close(getattr(carried, name), getattr(pm, name), rtol=0, atol=1e-7)


def _pendulum(S, make_world_option):
    """The JAX package's tests/test_grippers.py tendon world, its capsules
    with contype 0 (module docstring), in either package's spec module."""
    ms = S.ModelSpec("tendon_test", make_world_option())
    w = ms.worldbody
    for i, x in enumerate((0.0, 0.3)):
        b = w.add_body(S.BodySpec(f"link{i + 1}", pos=(x, 0, 0.5)))
        b.add_joint(S.JointSpec(f"j{i + 1}", type="hinge", axis=(0, 1, 0), damping=0.1, armature=0.01))
        b.add_geom(S.GeomSpec(f"g{i + 1}", type="capsule", fromto=(0, 0, 0, 0.2, 0, 0), size=(0.02,), contype=0,
                              conaffinity=0))
    ms.tendons.append(S.TendonSpec("cpl", joints=["j1", "j2"], coefs=[0.5, 0.5]))
    ms.equalities.append(S.EqualitySpec(kind="tendon", tendon1="cpl", solref=(0.005, 1.0)))
    ms.add_actuator(S.ActuatorSpec("m1", joint="j1", kind="motor", ctrlrange=(-2, 2)))
    return ms.compile()


def test_tendon_pendulum_matches_jax():
    from robosuite_tpu.models import spec as JS
    from robosuite_tpu.models.tasks import make_world_option as jopt
    from robosuite_tpu.physics import engine as JE
    from robosuite_tpu.physics.state import State as JState
    from robosuite_tpu_torch.models import spec as PS
    from robosuite_tpu_torch.models.tasks import make_world_option as popt

    jm, pm = _pendulum(JS, jopt), _pendulum(PS, popt)
    assert jm.npair == pm.npair == 0 and pm.ntendon == pm.neq == 1
    js = jax.jit(lambda s: JE.step_n(jm, s, jnp.asarray([0.8]), 100))(JState.make(jm))
    ps = engine.step_n(pm, State(qpos=pm.qpos0[None].clone(), qvel=torch.zeros(1, pm.nv), time=torch.zeros(1)),
                       torch.tensor([[0.8]]), 100)
    np.testing.assert_allclose(ps.qpos[0].numpy(), np.asarray(js.qpos), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ps.qvel[0].numpy(), np.asarray(js.qvel), rtol=0, atol=1e-4)
    assert abs(float(ps.qpos[0, 0] + ps.qpos[0, 1])) < 2e-3 and abs(float(ps.qpos[0, 0])) > 0.01


def _seeded(pm, B, seed):
    """(qpos, qvel, ctrl) of B scenarios around qpos0, numpy float32."""
    rng = np.random.default_rng(seed)
    q = pm.qpos0.numpy()[None] + 0.3 * rng.standard_normal((B, pm.nq)).astype(np.float32)
    qd = 0.5 * rng.standard_normal((B, pm.nv)).astype(np.float32)
    lo, hi = pm.actuator_ctrlrange.numpy().T
    c = (lo + (hi - lo) * rng.random((B, pm.nu))).astype(np.float32)
    return q.astype(np.float32), qd, c


@pytest.mark.parametrize("robot", ROBOTS)
def test_tendon_and_actuator_forces_match_jax(robot):
    from robosuite_tpu.physics import dynamics as JD
    from robosuite_tpu.physics import engine as JE

    jenv, penv = envs(robot)
    jm, pm = jenv.model, penv.model
    q, qd, c = _seeded(pm, 3, 5)
    Mdiag = (1.0 + np.random.default_rng(6).random((3, pm.nv))).astype(np.float32)
    jf = jax.vmap(lambda a, b, d: JD.tendon_forces(jm, a, b, Mdiag=d))(q, qd, Mdiag)
    pf = dynamics.tendon_forces(pm, torch.tensor(q), torch.tensor(qd), torch.tensor(Mdiag))
    for want, got in zip(jf, pf):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * max(1.0, float(np.abs(want).max())))
    # XArm7's one tendon has no spring, friction or range: it only transmits
    assert (float(np.abs(np.asarray(jf[0])).max()) > 0.0) == (robot != "XArm7")
    ja = np.asarray(jax.vmap(lambda a, b, u: JE.actuator_forces(jm, a, b, u))(q, qd, c))
    pa = engine.actuator_forces(pm, torch.tensor(q), torch.tensor(qd), torch.tensor(c)).numpy()
    np.testing.assert_allclose(pa, ja, rtol=0, atol=1e-5 * max(1.0, float(np.abs(ja).max())))


@pytest.mark.parametrize("robot", ROBOTS)
def test_fused_gate_refuses_tendon_worlds(robot):
    """The port's gate refuses each world as the JAX gate does, tendons
    first (robosuite_tpu/ops/pallas_substep.py:117-120)."""
    from robosuite_tpu.ops import pallas_substep as JPS

    jenv, penv = envs(robot)
    with pytest.raises(JPS.UnsupportedFused) as jerr:
        JPS.extract_spec(jenv, jenv.model)
    with pytest.raises(substep.UnsupportedFused) as perr:
        substep.extract_spec(penv, penv.model)
    assert str(perr.value) == str(jerr.value) == "tendons"
    assert penv._fused_for(penv.model) is None
    assert tables.check_model(penv.model, contacts=False) == 0


def test_forward_table_takes_general_actuators_and_fused_table_refuses_them():
    _, penv = envs("XArm7")
    pm = penv.model
    assert "general" in pm.actuator_kind and max(pm.actuator_tenid) >= 0
    assert tables.check_model(pm, contacts=False) == 0
    tables.pack(pm)  # K1's and K4's table: no actuator packed
    with pytest.raises(NotImplementedError, match="no fused law"):
        tables.check_model(pm)
    m = pm.replace(ntendon=0)  # the gate refuses the equalities alone too
    with pytest.raises(substep.UnsupportedFused, match="equality constraints"):
        substep.extract_spec(penv, m)


def test_xarm7_gripper_grasps_and_lifts():
    """JAX tests/test_grippers.py:18: one `general` servo on the tendon
    drives both fingers through the connect linkage, and the box rises."""
    from robosuite_tpu_torch.models.grippers.gripper_tester import GripperTester

    t = GripperTester("XArm7Gripper", device="cpu")
    assert t.model.ntendon == 1 and max(t.model.actuator_tenid) >= 0 and t.model.neq == 3
    out = t.run()
    assert out["finite"] and out["lifted"], out


@pytest.mark.parametrize("name", ["RethinkGripper", "JacoThreeFingerDexterousGripper",
                                  "RobotiqThreeFingerDexterousGripper", "Robotiq85Gripper", "Robotiq140Gripper"])
def test_other_grippers_stable(name):
    """JAX tests/test_grippers.py:33-45: the harness runs stably."""
    from robosuite_tpu_torch.models.grippers.gripper_tester import GripperTester

    out = GripperTester(name, device="cpu").run(n_steps_per_phase=75)
    assert out["finite"], out


@pytest.mark.parametrize("gripper", ["JacoThreeFingerGripper", "JacoThreeFingerDexterousGripper"])
def test_jaco_gripper_goal_matches_jax(gripper):
    """The gripper goal of Lift-Jaco with its three-finger gripper (one
    ramped action) and the dexterous one (each finger ramped from its own
    action element, robots/robot.py _gripper_goal) against the JAX robot's
    on random commands and actions, exactly."""
    import robosuite_tpu
    import robosuite_tpu_torch

    kw = dict(robots="Jaco", gripper_types=gripper, seed=0)
    jr = robosuite_tpu.make("Lift", **kw).robots[0]
    penv = robosuite_tpu_torch.make("Lift", device="cpu", **kw)
    r = penv.robots[0]
    n, dof = len(r.gripper_actuator_ids["right"]), r.rm.grippers["right"].dof
    assert (n, dof, penv.action_dim) == (3, 3 if "Dexterous" in gripper else 1, 6 + dof)
    rng = np.random.default_rng(9)
    cur = np.clip(rng.standard_normal((4, n)), -1, 1).astype(np.float32)
    a = rng.standard_normal((4, dof)).astype(np.float32)
    got = r._gripper_goal("right", torch.tensor(cur), torch.tensor(a)).numpy()
    want = np.stack([np.asarray(jr._gripper_goal("right", jnp.asarray(cur[i]), jnp.asarray(a[i]), jnp.float32))
                     for i in range(4)])
    np.testing.assert_array_equal(got, want)
