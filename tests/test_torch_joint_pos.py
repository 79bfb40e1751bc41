"""The port's JOINT_POSITION controller (controllers/parts/joint_pos.py)
against the JAX package's on the same random arm views: init_state,
set_goal and run in every impedance mode and input type, and the raw_pd
and no-compensation laws. The JAX functions are unbatched, so each
scenario runs through them alone. Bound: 1e-5, plus 1e-6 relative for
torques of order 100 (float32 rounding of one 7 x 7 matrix-vector product
summed in another order)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from robosuite_tpu_torch.controllers import factory
from robosuite_tpu_torch.controllers.base import ArmView
from robosuite_tpu_torch.controllers.parts import joint_pos as jp

B, N = 3, 7


def _views(rng):
    """A batch of random views (numpy): joint state, an SPD arm mass matrix
    and a bias; the Cartesian fields are unread by JOINT_POSITION."""
    A = rng.standard_normal((B, N, N))
    v = dict(joint_pos=rng.uniform(-2, 2, (B, N)), joint_vel=rng.standard_normal((B, N)),
             ref_pos=rng.standard_normal((B, 3)), ref_ori_mat=np.tile(np.eye(3), (B, 1, 1)),
             ref_pos_vel=np.zeros((B, 3)), ref_ori_vel=np.zeros((B, 3)), J_pos=np.zeros((B, 3, N)),
             J_ori=np.zeros((B, 3, N)), mass_matrix=A @ A.transpose(0, 2, 1) / N + 0.1 * np.eye(N),
             torque_compensation=5.0 * rng.standard_normal((B, N)), initial_joint=np.zeros((B, N)),
             origin_pos=np.zeros((B, 3)), origin_ori=np.tile(np.eye(3), (B, 1, 1)),
             origin_pos_vel=np.zeros((B, 3)), origin_ori_vel=np.zeros((B, 3)))
    return {k: x.astype(np.float32) for k, x in v.items()}


def _pair(views):
    from robosuite_tpu.controllers.base import ArmView as JArmView

    pview = ArmView(**{k: torch.as_tensor(x[0] if k == "initial_joint" else x) for k, x in views.items()})
    jviews = [JArmView(**{k: jnp.asarray(x[b]) for k, x in views.items()}) for b in range(B)]
    return pview, jviews


CONFIGS = [
    dict(),
    dict(impedance_mode="variable"),
    dict(impedance_mode="variable_kp"),
    dict(input_type="absolute"),
    dict(use_torque_compensation=False),
    dict(raw_pd=True, kp=500.0, kd=40.0),
    dict(raw_pd=True, use_torque_compensation=False, damping_ratio=0.7),
]


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "default")
def test_set_goal_and_run_match_jax(kw):
    from robosuite_tpu.controllers.parts import joint_pos as jjp

    rng = np.random.default_rng(len(str(kw)))
    views = _views(rng)
    pview, jviews = _pair(views)
    pcfg = factory.arm_controller_config("JOINT_POSITION", **kw)
    jcfg = jjp.JointPosConfig(**dataclasses.asdict(pcfg))
    action = rng.uniform(-1.2, 1.2, (B, pcfg.control_dim)).astype(np.float32)
    if pcfg.impedance_mode != "fixed":  # kp / damping-ratio inputs around their ranges
        action[:, : pcfg.control_dim - N] *= 200.0
    pst = jp.set_goal(pcfg, jp.init_state(pcfg, pview), pview, torch.as_tensor(action))
    tau = jp.run(pcfg, pst, pview)
    for b in range(B):
        jst = jjp.set_goal(jcfg, jjp.init_state(jcfg, jviews[b]), jviews[b], jnp.asarray(action[b]))
        for name in ("goal_qpos", "kp", "kd"):
            np.testing.assert_allclose(getattr(pst, name)[b].numpy(), np.asarray(getattr(jst, name)), rtol=1e-6,
                                       atol=1e-5, err_msg=name)
        np.testing.assert_allclose(tau[b].numpy(), np.asarray(jjp.run(jcfg, jst, jviews[b])), rtol=1e-6, atol=1e-5)


def test_factory_resolves_joint_position_as_jax():
    """load_composite_controller_config("JOINT_POSITION") gives the JAX
    package's config: the arm_controller_config defaults over the
    dataclass's (damping_ratio_limits (0, 100))."""
    from robosuite_tpu.controllers import factory as jfactory

    got = factory.load_composite_controller_config("JOINT_POSITION", robot="Panda", arms=["right"])["right"]
    want = jfactory.load_composite_controller_config("JOINT_POSITION", robot="Panda", arms=["right"])["right"]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.control_dim == 7 and got.damping_ratio_limits == (0.0, 100.0)
    with pytest.raises(ValueError, match="unknown controller type"):
        factory.arm_controller_config("JOINT_ACCELERATION")
