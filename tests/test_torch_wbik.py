"""The WHOLE_BODY_IK composite (and WHOLE_BODY_MINK_IK, mapped onto it) and
the third-party composites in the port against the JAX package on the CPU
(one torch thread):

  * wbik_solve (controllers/composite/wbik.py) against the JAX
    wbik.wbik_solve on the problems of Lift-Baxter under WHOLE_BODY_IK
    (two arms, 14 dofs), Lift-PandaOmron under
    default_pandaomron_whole_body_ik.json (the torso lift and the arm, 8
    dofs) and Lift-Tiago under default_tiago_whole_body_ik.json (the torso
    and two arms, 13 dofs): the problem's structure (selected dofs, slices,
    nullspace gains by joint name, torso mask, posture) equal, and the
    solve on seeded Jacobians, joints and targets, with absolute and delta
    input, within 1e-5 rad of the JAX one. The port solves in float64 and
    the JAX package in float32: the difference is the float32 solve's
    rounding, at most 1.6e-6 rad on these inputs (Tiago's; the posture's
    projection scales its rounding by the nullspace gains, Tiago's 100 on
    the torso);
  * one step_batch policy step of Lift-PandaOmron (and, in
    tests/test_torch_wbik_step.py, Lift-Tiago) under their whole-body IK
    configs from an injected JAX state
    (test_torch_mobile_robots.hold_step): the JOINT_POSITION goals the
    solve gives at 1e-5, each substep at qpos 1e-5 and qvel 1e-4; Tiago's
    JAX robot with its arms' JOINT_POSITION configs sized to the arms'
    6 joints (jax_arm_dims: the JAX factory leaves them 7 wide, and its
    Tiago-WBIK step raises);
  * the action layout (6-wide task-space targets, grippers) and its
    bounds (+-3.2), the fused gate's "WBIK composite" refusal (Lift-Panda),
    WHOLE_BODY_MINK_IK's posture weights as the nullspace weights, and a
    registered third-party composite's goals tracked by the arms'
    JOINT_POSITION controllers.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from robosuite_tpu_torch.controllers.composite import wbik as pwbik
from robosuite_tpu_torch.ops import substep as psub
from tests.test_torch_mobile_robots import hold_step

CFG = {
    "Baxter": "WHOLE_BODY_IK",
    "PandaOmron": "robosuite_tpu/controllers/config/robots/default_pandaomron_whole_body_ik.json",
    "Tiago": "robosuite_tpu/controllers/config/robots/default_tiago_whole_body_ik.json",
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build_both(robot, cfg):
    import robosuite_tpu
    import robosuite_tpu_torch

    return (robosuite_tpu.make("Lift", robots=robot, seed=0, controller_configs=cfg),
            robosuite_tpu_torch.make("Lift", robots=robot, seed=0, device="cpu",
                                     controller_configs=cfg.replace("robosuite_tpu/", "robosuite_tpu_torch/")))


def _rotations(rng, n, scale):
    """n random rotation matrices of angle up to ~scale (float32)."""
    from scipy.spatial.transform import Rotation

    return Rotation.from_rotvec(scale * rng.uniform(-1, 1, (n, 3))).as_matrix().astype(np.float32)


@pytest.mark.parametrize("robot", list(CFG))
def test_wbik_solve_matches_jax(robot):
    from robosuite_tpu.controllers.composite import wbik as jwbik

    jenv, penv = build_both(robot, CFG[robot])
    jr, pr = jenv.robots[0], penv.robots[0]
    jw, pw = jr._wbik_build(), pr._wbik_build()
    assert dataclasses.asdict(pw["cfg"]) == dataclasses.asdict(jw["cfg"])
    assert pw["slices"] == jw["slices"]
    np.testing.assert_array_equal(pw["qp"].numpy(), jw["qpos_idx"])
    np.testing.assert_array_equal(pw["qv"].numpy(), jw["qvel_idx"])
    np.testing.assert_array_equal(pw["q0"].numpy(), np.asarray(jw["q0"]))
    if robot == "Tiago":
        assert pw["cfg"].nullspace_gains[0] == 100.0 and pw["cfg"].torso_mask[0] == 1.0
    cfg, n, S = pw["cfg"], len(pw["qv"]), len(pr.arms)
    for input_type in ("absolute", "delta"):
        cfg_t = dataclasses.replace(cfg, input_type=input_type)
        rng = np.random.default_rng(40 + S)
        B = 4
        J = (0.5 * rng.standard_normal((B, 6 * S, n))).astype(np.float32)
        q = (pw["q0"].numpy() + 0.2 * rng.standard_normal((B, n))).astype(np.float32)
        spos = rng.uniform(-0.5, 0.5, (B, S, 3)).astype(np.float32)
        tpos = (spos + 0.05 * rng.standard_normal((B, S, 3))).astype(np.float32)
        smat = _rotations(rng, B * S, 3.0).reshape(B, S, 3, 3)
        tmat = np.einsum("bsij,bsjk->bsik", _rotations(rng, B * S, 0.3).reshape(B, S, 3, 3), smat)
        got = pwbik.wbik_solve(cfg_t, *(torch.tensor(x) for x in (J, q)), pw["q0"],
                               *(torch.tensor(x) for x in (spos, smat, tpos, tmat))).numpy()
        assert got.dtype == np.float32
        for b in range(B):
            want = np.asarray(jwbik.wbik_solve(jw["cfg"], jnp.asarray(J[b]), jnp.asarray(q[b]), jw["q0"],
                                               jnp.asarray(spos[b]), jnp.asarray(smat[b]), jnp.asarray(tpos[b]),
                                               jnp.asarray(tmat[b])))
            np.testing.assert_allclose(got[b], want, rtol=0, atol=1e-5, err_msg=f"{robot} {input_type} {b}")


def test_wbik_layout_bounds_and_gate():
    import robosuite_tpu_torch

    env = robosuite_tpu_torch.make("Lift", robots="Panda", controller_configs="WHOLE_BODY_IK", device="cpu")
    r = env.robots[0]
    assert r.wbik_spec is not None and r.action_split_indexes() == {"right": (0, 6), "right_gripper": (6, 7)}
    lo, hi = env.action_spec
    np.testing.assert_array_equal(lo, np.float32([-3.2] * 6 + [-1.0]))
    np.testing.assert_array_equal(hi, np.float32([3.2] * 6 + [1.0]))
    with pytest.raises(psub.UnsupportedFused, match="WBIK composite"):
        psub.extract_spec(env, env.model)
    assert env._fused_for(env.model) is None
    # WHOLE_BODY_MINK_IK: the WBIK runtime with the posture weights
    mink = robosuite_tpu_torch.make("Lift", robots="PandaOmron", controller_configs="WHOLE_BODY_MINK_IK",
                                    device="cpu").robots[0]
    assert mink.composite_type == "WHOLE_BODY_IK"
    assert mink.wbik_spec["nullspace_joint_weights"]["robot0_torso_waist_roll"] == 200.0
    with pytest.raises(ValueError, match="unknown composite controller"):
        robosuite_tpu_torch.make("Lift", robots="Panda", controller_configs={"type": "NO_SUCH"}, device="cpu")


def test_third_party_composite_goals_are_tracked():
    """A registered goal transform (the arm's joints offset by 0.01 x its
    target's first entry) becomes the arms' JOINT_POSITION goals (kp 1000,
    absolute) at policy rate."""
    import robosuite_tpu_torch
    from robosuite_tpu_torch.controllers.composite import composite_controller as cc

    @cc.register_composite_controller("TEST_OFFSET", arm_action_dim=3)
    def offset(robot, kin, qpos, qvel, targets, cfg):
        return {arm: qpos[:, robot.arm_qpos_idx[arm]] + cfg["scale"] * targets[arm][:, :1] for arm in robot.arms}

    try:
        env = robosuite_tpu_torch.make("Lift", robots="Panda", device="cpu",
                                       controller_configs={"type": "TEST_OFFSET",
                                                           "composite_controller_specific_configs": {"scale": 0.01}})
        r = env.robots[0]
        assert env.action_dim == 4 and r.action_split_indexes() == {"right": (0, 3), "right_gripper": (3, 4)}
        assert r.arm_cfg["right"].kp == 1000.0 and r.arm_cfg["right"].input_type == "absolute"
        s, _ = env.reset_batch(2, torch.Generator().manual_seed(0))
        a = torch.tensor([[1.0, 0.0, 0.0, -1.0], [-0.5, 0.0, 0.0, 1.0]])
        s2, *_ = env.step_batch(s, a)
        q = s.physics.qpos[:, r.arm_qpos_idx["right"]]
        torch.testing.assert_close(s2.ctrl.arm["right"].goal_qpos, q + 0.01 * a[:, :1], rtol=0, atol=0)
        g = s2.ctrl.gripper_action["right"]  # ramped from the gripper's slice, opposite signs
        assert bool((g[0] != 0).all()) and torch.equal(g[0], -g[1])
    finally:
        cc.THIRD_PARTY_COMPOSITE_CONTROLLERS.pop("TEST_OFFSET")


def targets(robot, seed):
    """(2, A) absolute targets near each arm's eef in its base frame: the
    JAX package's reset pose of the eef (from the port) plus 3 cm, a
    small rotation; the grippers closing."""
    import robosuite_tpu_torch

    env = robosuite_tpu_torch.make("Lift", robots=robot, seed=0, device="cpu",
                                   controller_configs=CFG[robot].replace("robosuite_tpu/", "robosuite_tpu_torch/"))
    r = env.robots[0]
    s, _ = env.reset_batch(2, torch.Generator().manual_seed(31))
    from robosuite_tpu_torch.physics import engine
    from robosuite_tpu_torch.utils import transforms as T

    kin, M, bias = engine.forward_products(env.model, s.physics.qpos, s.physics.qvel)
    rng = np.random.default_rng(seed)
    a = np.zeros((2, env.action_dim), np.float32)
    idx = r.action_split_indexes()
    for arm in r.arms:
        v = r.arm_view(kin, M, bias, s.physics.qpos, s.physics.qvel, arm)
        Rt = v.origin_ori.transpose(1, 2)
        p = (Rt @ (v.ref_pos - v.origin_pos)[..., None])[..., 0].numpy()
        aa = T.quat2axisangle(T.mat2quat(Rt @ v.ref_ori_mat)).numpy()
        st = idx[arm][0]
        a[:, st:st + 3] = p + 0.03 * rng.standard_normal((2, 3))
        a[:, st + 3:st + 6] = aa + 0.05 * rng.standard_normal((2, 3))
        a[:, idx[f"{arm}_gripper"][0]] = 1.0
    return a


def test_wbik_step_matches_jax():
    """PandaOmron's (Tiago's: tests/test_torch_wbik_step.py, for the time)."""
    hold_step("PandaOmron", CFG["PandaOmron"], action=targets("PandaOmron", 50))
