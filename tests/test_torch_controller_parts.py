"""The port's JOINT_VELOCITY, JOINT_TORQUE and IK_POSE part controllers
(controllers/parts/joint_vel.py, joint_tor.py, ik.py) and its factory
(controllers/factory.py) against the JAX package's, on the same
numpy-seeded arm views (each scenario through the unbatched JAX function);
IK also against robosuite's own solves recorded at 48 Lift states a robot
(tests/fixtures/ik_probe_{panda,sawyer}.npz, atol 2e-4, as
tests/test_ik_parity.py holds the JAX package).

Bounds: set_goal and run rtol 1e-6, atol 1e-5 (as
tests/test_torch_joint_pos.py). IK's q_des against the JAX solve 1e-5: the
port solves in float64, the JAX package in float32 (on the fixtures'
float32-rounded inputs the port's q_des lies 2.6e-7 from robosuite's, the
JAX package's 4.0e-7, the two 2.7e-7 apart); the clipped input 1e-6
(translation) and 1e-5 (the rotation matrix), as the JAX package's own
test holds it."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robosuite_tpu_torch.controllers import factory
from robosuite_tpu_torch.controllers.parts import ik, joint_tor, joint_vel
from tests.test_torch_door import one_thread  # noqa: F401  (an autouse fixture: one torch thread)
from tests.test_torch_joint_pos import B, N, _pair, _views

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
PARTS = sorted(factory.ALL_PART_CONTROLLERS)


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5, err_msg=err_msg)


def _jv_cfgs():
    return [dict(), dict(velocity_limits=(-0.3, 0.3), kp=3.0, ki=0.5, kd=0.2), dict(derr_window=3, ki=1.0)]


@pytest.mark.parametrize("kw", _jv_cfgs(), ids=["default", "limits+pid", "window3"])
def test_joint_velocity_matches_jax(kw):
    """set_goal, then run three times with the PID state carried (and,
    for the clip, the actuator limits of a Panda), with and without the
    actuator clip; the new state's every leaf, the saturation flag too."""
    from robosuite_tpu.controllers.parts import joint_vel as jjv

    rng = np.random.default_rng(len(str(kw)))
    views = _views(rng)
    pview, jviews = _pair(views)
    pcfg = factory.arm_controller_config("JOINT_VELOCITY", **kw)
    jcfg = jjv.JointVelConfig(**dataclasses.asdict(pcfg))
    action = rng.uniform(-1.2, 1.2, (B, N)).astype(np.float32)
    lo, hi = np.full(N, -8.0, np.float32), np.full(N, 8.0, np.float32)
    for clip in (False, True):
        lims = (torch.as_tensor(lo), torch.as_tensor(hi)) if clip else (None, None)
        pst = joint_vel.set_goal(pcfg, joint_vel.init_state(pcfg, pview), pview, torch.as_tensor(action))
        jst = [jjv.set_goal(jcfg, jjv.init_state(jcfg, jviews[b]), jviews[b], jnp.asarray(action[b])) for b in range(B)]
        for _ in range(3):
            tau, pst = joint_vel.run(pcfg, pst, pview, *lims)
            for b in range(B):
                jl = (jnp.asarray(lo), jnp.asarray(hi)) if clip else (None, None)
                tau_j, jst[b] = jjv.run(jcfg, jst[b], jviews[b], *jl)
                _close(tau[b].numpy(), np.asarray(tau_j), "torques")
                for f in dataclasses.fields(pst):
                    got, want = getattr(pst, f.name)[b].numpy(), np.asarray(getattr(jst[b], f.name))
                    if f.name == "saturated":
                        assert bool(got) == bool(want)
                    else:
                        _close(got, want, f.name)
        if clip:
            assert bool(pst.saturated.any())  # torque compensation of 5 N m scale and kp 0.25 - 3 reach 8 N m


@pytest.mark.parametrize("comp", [True, False])
def test_joint_torque_matches_jax(comp):
    """set_goal clips to the torque limits; run adds the compensation or not."""
    from robosuite_tpu.controllers.parts import joint_tor as jjt

    rng = np.random.default_rng(7 + comp)
    views = _views(rng)
    pview, jviews = _pair(views)
    pcfg = factory.arm_controller_config("JOINT_TORQUE", output_max=2.0, output_min=-2.0,
                                         use_torque_compensation=comp)
    jcfg = jjt.JointTorConfig(**dataclasses.asdict(pcfg))
    action = rng.uniform(-1.2, 1.2, (B, N)).astype(np.float32)
    lo, hi = -np.linspace(0.5, 3.0, N).astype(np.float32), np.linspace(0.5, 3.0, N).astype(np.float32)
    pst = joint_tor.set_goal(pcfg, joint_tor.init_state(pcfg, pview), torch.as_tensor(action), torch.as_tensor(lo),
                             torch.as_tensor(hi))
    tau = joint_tor.run(pcfg, pst, pview)
    for b in range(B):
        jst = jjt.set_goal(jcfg, jjt.init_state(jcfg), jnp.asarray(action[b]), jnp.asarray(lo), jnp.asarray(hi))
        _close(pst.goal_torque[b].numpy(), np.asarray(jst.goal_torque), "goal_torque")
        _close(tau[b].numpy(), np.asarray(jjt.run(jcfg, jst, jviews[b])), "torques")
    at_limit = (pst.goal_torque == torch.as_tensor(hi)) | (pst.goal_torque == torch.as_tensor(lo))
    assert bool(at_limit.any()) and not bool(at_limit.all())  # some goals clipped at the limits


def _ik_views(rng):
    """Random views with a full-rank 6 x 7 Jacobian at the scale of a
    Panda's (about 0.5 m a rad)."""
    v = _views(rng)
    J = (0.5 * rng.standard_normal((B, 6, N))).astype(np.float32)
    v["J_pos"], v["J_ori"] = J[:, :3].copy(), J[:, 3:].copy()
    v["initial_joint"] = np.tile(rng.uniform(-1, 1, N).astype(np.float32), (B, 1))
    return v


def test_ik_set_goal_and_run_match_jax():
    """clip_ik_input (some deltas past both limits, one zero rotation),
    solve_q_des with every branch of its clip, set_goal's inner JOINT_POSITION
    goal and run's torques, against the JAX IK."""
    from robosuite_tpu.controllers.parts import ik as jik

    rng = np.random.default_rng(11)
    views = _ik_views(rng)
    pview, jviews = _pair(views)
    pcfg = factory.arm_controller_config("IK_POSE")
    jcfg = jik.IKConfig(**dataclasses.asdict(pcfg))
    action = rng.uniform(-0.06, 0.06, (B, 6)).astype(np.float32)
    action[0, 3:] = 0.0
    action[1, :3] = 0.005
    pst = ik.set_goal(pcfg, ik.init_state(pcfg, pview), pview, torch.as_tensor(action))
    tau = ik.run(pcfg, pst, pview)
    dpos, dquat = ik.clip_ik_input(pcfg, torch.as_tensor(action[:, :3]), torch.as_tensor(action[:, 3:]))
    for b in range(B):
        jd, jq = jik.clip_ik_input(jcfg, jnp.asarray(action[b, :3]), jnp.asarray(action[b, 3:]))
        np.testing.assert_allclose(dpos[b].numpy(), np.asarray(jd), rtol=0, atol=1e-6)
        np.testing.assert_allclose(dquat[b].numpy(), np.asarray(jq), rtol=0, atol=1e-6)
        jst = jik.set_goal(jcfg, jik.init_state(jcfg, jviews[b]), jviews[b], jnp.asarray(action[b]))
        for name in ("goal_qpos", "kp", "kd"):
            _close(getattr(pst.joint, name)[b].numpy(), np.asarray(getattr(jst.joint, name)), name)
        # the torques carry q_des's float64-vs-float32 difference times kp M
        # (about 150 here): 1e-5 of the largest, as the OSC torques are held
        tau_j = np.asarray(jik.run(jcfg, jst, jviews[b]))
        np.testing.assert_allclose(tau[b].numpy(), tau_j, rtol=0, atol=1e-5 * max(1.0, float(np.abs(tau_j).max())))
    norms = np.linalg.norm(action[:, :3], axis=-1)
    assert (norms > pcfg.ik_pos_limit).any() and (norms < pcfg.ik_pos_limit).any()


@pytest.mark.parametrize("robot", ["panda", "sawyer"])
def test_ik_solve_matches_robosuite_and_jax(robot):
    """solve_q_des from robosuite's Jacobians, joints and clipped deltas
    against robosuite's q_des (2e-4) and the JAX package's float32 solve
    (1e-5); clip_ik_input of the raw actions against robosuite's clipped
    (dpos, drot)."""
    from robosuite_tpu.controllers.parts import ik as jik
    from robosuite_tpu.utils import transforms as JT

    fx = np.load(os.path.join(FIXDIR, f"ik_probe_{robot}.npz"))
    cfg = ik.IKConfig(dim=fx["q"].shape[1])
    f32 = {k: torch.as_tensor(fx[k], dtype=torch.float32) for k in ("J", "q", "dpos", "drot", "initial_joint")}
    q_des = ik.solve_q_des(cfg, f32["J"], f32["q"], f32["initial_joint"], f32["dpos"], f32["drot"]).numpy()
    np.testing.assert_allclose(q_des, fx["q_des"], rtol=0, atol=2e-4)
    jcfg = jik.IKConfig(dim=fx["q"].shape[1])
    q0 = jnp.asarray(fx["initial_joint"], dtype=jnp.float32)
    solve = jax.jit(jax.vmap(lambda J, q, dpos, drot: jik.solve_q_des(jcfg, J, q, q0, dpos, drot)))
    want = np.asarray(solve(*(jnp.asarray(fx[k], dtype=jnp.float32) for k in ("J", "q", "dpos", "drot"))))
    np.testing.assert_allclose(q_des, want, rtol=0, atol=1e-5)
    act = torch.as_tensor(fx["actions"], dtype=torch.float32)
    dpos, dquat = ik.clip_ik_input(cfg, act[:, :3], act[:, 3:6])
    np.testing.assert_allclose(dpos.numpy(), fx["dpos"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(JT.quat2mat(jnp.asarray(dquat.numpy()))), fx["drot"], rtol=0, atol=1e-5)


def _fields(cfg):
    """A config's fields, lists as tuples (the JAX factory keeps a JSON
    list where the field is not one of OSC's output or limit pairs)."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in dataclasses.asdict(cfg).items()}


def _same(got, want):
    assert type(got).__name__ == type(want).__name__
    assert _fields(got) == _fields(want)
    for prop in ("control_dim", "base_dim", "interp_steps"):
        if hasattr(want, prop):
            assert getattr(got, prop) == getattr(want, prop), prop


@pytest.mark.parametrize("name", PARTS)
def test_factory_part_name_matches_jax(name):
    """A part name gives the JAX factory's defaults (JOINT_VELOCITY: kp
    0.25, output 1, not the part JSON's 3.0 and 0.5), and the part JSON as
    a body_parts entry gives the JAX factory's flattening of it."""
    from robosuite_tpu.controllers import factory as jfactory

    _same(factory.load_composite_controller_config(name, robot="Panda")["right"],
          jfactory.load_composite_controller_config(name, robot="Panda", arms=["right"])["right"])
    part = factory.load_part_controller_config(name)
    assert part["type"] == name
    composite = {"type": "BASIC", "body_parts": {"arms": {"right": part}}}
    _same(factory.load_composite_controller_config(composite, robot="Panda")["right"],
          jfactory.load_composite_controller_config(composite, robot="Panda", arms=["right"])["right"])
    if name == "JOINT_VELOCITY":
        got = factory.arm_controller_config(name)
        assert (got.kp, got.output_max) == (0.25, 1.0)


@pytest.mark.parametrize("robot", ["Panda", "Sawyer"])
def test_factory_robot_default_and_interpolation_match_jax(robot):
    """The robot's default JSON, and a body_parts dict with OSC's linear
    interpolation and its ramp, and one whose non-OSC arm carries them
    (dropped, as the JAX factory drops them); and an unknown type."""
    from robosuite_tpu.controllers import factory as jfactory

    _same(factory.load_composite_controller_config(None, robot=robot)["right"],
          jfactory.load_composite_controller_config(None, robot=robot, arms=["right"])["right"])
    for t, extra in (("OSC_POSE", dict(interpolation="linear", ramp_ratio=0.5)),
                     ("OSC_POSITION", dict(interpolation="linear", input_type="absolute", input_ref_frame="world")),
                     ("JOINT_TORQUE", dict(interpolation="linear", ramp_ratio=0.5, torque_limits=None))):
        composite = {"type": "BASIC", "body_parts": {"arms": {"right": dict(type=t, **extra)}}}
        got = factory.load_composite_controller_config(composite, robot=robot)["right"]
        _same(got, jfactory.load_composite_controller_config(composite, robot=robot, arms=["right"])["right"])
    assert factory.robot_config_name("PandaDexRH") == "panda_dex"
    with pytest.raises(ValueError, match="unknown controller type"):
        factory.arm_controller_config("OSC_FOO")
