"""Equality constraints in the port against the JAX package, on the CPU
(each on one torch thread):

  * the three cases of the JAX package's tests/test_equality.py: a free
    bar held at one end by a connect equality (30 x 25 substeps), two
    hinges coupled by a joint equality (30 x 25 substeps), and Lift-XArm7
    compiling its three equalities. Each world steps in both packages
    (both take the pairless, equality-only velocity update) and the
    port's qpos and qvel are held to the JAX engine's at every policy step
    (qpos 1e-5 and qvel 1e-4, the step tests' tolerances), and the JAX
    test's own conditions hold on the port's result;
  * equality_rows (connect, joint and tendon rows) of Lift-XArm7 and
    Lift-IIWA at seeded states against the JAX function: the rows 1e-6,
    aref 1e-5 of max(1, its largest);
  * vel_update_plain with the ne equality rows after the contact rows
    (ntot = 3K + ne) against the JAX _vel_update_xla on the same inputs
    (Lift-XArm7 at a seeded state: ne 7): qvel 1e-5 of max(1, its
    largest), f 1e-4 of max(1, its largest). The JAX solve runs eagerly,
    scenario by scenario (XLA:CPU compiles its unrolled Choleskys at nv 19
    for minutes).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robosuite_tpu_torch.ops import contact_solve, forward
from robosuite_tpu_torch.physics import contact as C
from robosuite_tpu_torch.physics import engine, equality
from robosuite_tpu_torch.physics.state import State


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _connect_world(S):
    ms = S.ModelSpec("eq")
    w = ms.worldbody
    anchor_body = w.add_body(S.BodySpec("anchor", pos=(0, 0, 1.0)))
    anchor_body.inertial = S.InertialSpec(mass=0.0, diaginertia=(0, 0, 0))
    bar = w.add_body(S.BodySpec("bar", pos=(0.1, 0, 0.9)))
    bar.add_joint(S.JointSpec("barj", type="free"))
    bar.add_geom(S.GeomSpec("barg", type="capsule", size=(0.01, 0.1), contype=0, conaffinity=0, density=1000))
    ms.equalities.append(S.EqualitySpec(kind="connect", body1="bar", body2="anchor", anchor=(0, 0, 0.1)))
    return ms.compile()


def _joint_world(S):
    ms = S.ModelSpec("eqj")
    w = ms.worldbody
    for name, x in (("a", 0.0), ("b", 0.3)):
        b = w.add_body(S.BodySpec(name, pos=(x, 0, 0.5)))
        b.add_joint(S.JointSpec(f"j{name}", type="hinge", axis=(0, 1, 0), damping=0.5))
        b.inertial = S.InertialSpec(mass=0.5, pos=(0, 0, -0.1), diaginertia=(0.01, 0.01, 0.002))
    ms.option.gravity = np.zeros(3)
    ms.add_actuator(S.ActuatorSpec("ma", joint="ja", kind="position", kp=20.0))
    ms.equalities.append(S.EqualitySpec(kind="joint", joint1="jb", joint2="ja", polycoef=(0, 1, 0, 0, 0),
                                        solref=(0.01, 1)))
    return ms.compile()


def _run_both(world, q0, ctrl, steps):
    """The world built in both packages, stepped `steps` x 25 substeps from
    q0 under ctrl, the port held to the JAX engine at every policy step;
    -> the port's model and final State."""
    from robosuite_tpu.models import spec as JS
    from robosuite_tpu.physics import engine as JE
    from robosuite_tpu.physics.state import State as JState
    from robosuite_tpu_torch.models import spec as PS

    jm, pm = world(JS), world(PS)
    assert jm.npair == pm.npair == 0 and jm.neq == pm.neq == 1
    js = JState.make(jm).replace(qpos=jnp.asarray(q0, dtype=jnp.float32))
    ps = State(qpos=torch.tensor(q0, dtype=torch.float32)[None], qvel=torch.zeros(1, pm.nv), time=torch.zeros(1))
    jstep = jax.jit(lambda s: JE.step_n(jm, s, jnp.asarray(ctrl, dtype=jnp.float32), 25))
    pctrl = torch.tensor(ctrl, dtype=torch.float32)[None]
    for i in range(steps):
        js, ps = jstep(js), engine.step_n(pm, ps, pctrl, 25)
        np.testing.assert_allclose(ps.qpos[0].numpy(), np.asarray(js.qpos), rtol=0, atol=1e-5, err_msg=f"{i}")
        np.testing.assert_allclose(ps.qvel[0].numpy(), np.asarray(js.qvel), rtol=0, atol=1e-4, err_msg=f"{i}")
    return pm, ps


def test_connect_holds_pendulum_tip():
    """JAX tests/test_equality.py:14: the bar, displaced, swings about the
    held point, its tip within 2 cm of it."""
    from robosuite_tpu_torch.models import spec as PS
    from robosuite_tpu_torch.physics import kinematics

    q0 = _connect_world(PS).qpos0.numpy().copy()
    q0[0] += 0.05
    q0[2] -= 0.02
    pm, ps = _run_both(_connect_world, q0, np.zeros(0), 30)
    kin = kinematics.fk(pm, ps.qpos)
    bid = pm.body_name2id("bar")
    tip = (kin.xpos[0, bid] + kin.xmat[0, bid] @ torch.tensor([0.0, 0.0, 0.1])).numpy()
    assert np.linalg.norm(tip - np.array([0.1, 0, 1.0])) < 0.02, tip
    assert abs(float(ps.qpos[0, 0]) - q0[0]) > 0.01


def test_joint_coupling_tracks_polycoef():
    """JAX tests/test_equality.py:53: the servo drives joint a to 0.6 and
    the coupled joint b follows."""
    pm, ps = _run_both(_joint_world, np.zeros(2), np.array([0.6]), 30)
    q = ps.qpos[0].numpy()
    assert abs(q[0] - 0.6) < 0.1 and abs(q[1] - q[0]) < 0.05, q


_ENVS = {}


def envs(robot):
    if robot not in _ENVS:
        import robosuite_tpu
        import robosuite_tpu_torch

        kw = dict(robots=robot, reward_shaping=True, seed=0, cube_size=[0.021, 0.021, 0.021])
        _ENVS[robot] = robosuite_tpu.make("Lift", **kw), robosuite_tpu_torch.make("Lift", device="cpu", **kw)
    return _ENVS[robot]


def test_xarm7_gripper_compiles_with_equalities():
    """JAX tests/test_equality.py:78, and the rows it gives: 2 connects and
    a joint coupling, 7 rows."""
    _, penv = envs("XArm7")
    m = penv.model
    assert m.neq == 3 and m.eq_kind == ("connect", "connect", "joint")
    assert equality.equality_row_count(m) == 7
    assert C.contact_warmstart_dim(m) == 3 * 122 + 7


def _seeded_state(pm, B, seed):
    rng = np.random.default_rng(seed)
    q = pm.qpos0.numpy()[None] + 0.05 * rng.standard_normal((B, pm.nq)).astype(np.float32)
    qd = 0.3 * rng.standard_normal((B, pm.nv)).astype(np.float32)
    return q.astype(np.float32), qd


@pytest.mark.parametrize("robot", ["XArm7", "IIWA"])
def test_equality_rows_match_jax(robot):
    from robosuite_tpu.physics import equality as JEQ
    from robosuite_tpu.physics import kinematics as JK

    jenv, penv = envs(robot)
    jm, pm = jenv.model, penv.model
    q, qd = _seeded_state(pm, 3, 7)
    jJ, jaref = jax.jit(jax.vmap(lambda a, b: JEQ.equality_rows(jm, JK.fk(jm, a), a, b)))(q, qd)
    kin = forward.forward_plain(pm, torch.tensor(q), torch.tensor(qd), *forward.runtime_leaves(pm, 3))[0]
    pJ, paref = equality.equality_rows(pm, kin, torch.tensor(q), torch.tensor(qd))
    np.testing.assert_allclose(pJ.numpy(), np.asarray(jJ), rtol=0, atol=1e-6)
    jaref = np.asarray(jaref)
    np.testing.assert_allclose(paref.numpy(), jaref, rtol=0, atol=1e-5 * max(1.0, float(np.abs(jaref).max())))
    assert float(np.abs(jaref).max()) > 0.0


def test_vel_update_plain_with_equality_rows_matches_jax():
    from robosuite_tpu.ops import pallas_contact as JPC

    _, penv = envs("XArm7")
    pm = penv.model
    B = 2
    q, qd = _seeded_state(pm, B, 8)
    q, qd = torch.tensor(q), torch.tensor(qd)
    kin, M, bias = forward.forward_plain(pm, q, qd, *forward.runtime_leaves(pm, B))
    qfrc, extra = engine.total_smooth_force(pm, q, qd, torch.zeros(B, pm.nu), M, bias)
    eq = equality.equality_rows(pm, kin, q, qd)
    JfT, aref, reg3, mu, act = C.solver_inputs(pm, kin, C.narrowphase(pm, kin), qd, pm.timestep, eq)
    K, ne = act.shape[1], 7
    assert JfT.shape[2] == 3 * K + ne and bool((reg3[:, 3 * K:] == torch.tensor(0.05)).all())
    act = act.clone()
    act[:, :3] = 1.0  # a few contact rows active beside the equality rows
    args = [t.contiguous() for t in (M, JfT, aref, qfrc, qd, pm.dof_damping + extra, reg3, mu, act)]
    qv_p, f_p = contact_solve.vel_update_plain(*args, C.APGD_ITERS, C.POWER_ITERS, pm.timestep)
    with jax.disable_jit():
        out = [JPC._vel_update_xla(*(jnp.asarray(a[b].numpy()) for a in args), K, ne, C.APGD_ITERS, C.POWER_ITERS,
                                   pm.timestep) for b in range(B)]
    qv_j, f_j = np.stack([np.asarray(o[0]) for o in out]), np.stack([np.asarray(o[1]) for o in out])
    np.testing.assert_allclose(qv_p.numpy(), qv_j, rtol=0, atol=1e-5 * max(1.0, float(np.abs(qv_j).max())))
    np.testing.assert_allclose(f_p.numpy(), f_j, rtol=0, atol=1e-4 * max(1.0, float(np.abs(f_j).max())))
    assert float(np.abs(f_j[:, 3 * K:]).min()) > 0.0
