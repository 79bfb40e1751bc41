"""K3's plain version (ops/substep.substep_plain, what the fused wrapper
runs on CPU tensors) against the JAX package's make_fused_substep called
unbatched (its _xla composition) for one substep of the Lift world, at
contact states with the OSC law driving the arm toward a nearby goal.
Bounds: qpos 1e-5, qvel 1e-4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robosuite_tpu_torch.ops import forward, substep
from tests.test_torch_door import one_thread  # noqa: F401  (an autouse fixture: one torch thread)

CUBE = [0.021, 0.021, 0.021]
INIT = np.array([0, np.pi / 16.0, 0.00, -np.pi / 2.0 - np.pi / 3.0, 0.00, np.pi - 0.2, np.pi / 4])


def contact_states(rng, B):
    """Arm near its init pose, cube resting on the table (1.2 mm deep)."""
    qpos = np.zeros((B, 16), np.float32)
    qpos[:, :7] = INIT + 0.2 * rng.standard_normal((B, 7))
    qpos[:, 7:9] = [0.02, -0.02]
    qpos[:, 9:11] = rng.uniform(-0.03, 0.03, (B, 2))
    qpos[:, 11] = 0.8 + CUBE[2] - 0.0012
    yaw = rng.uniform(0, 2 * np.pi, B)
    qpos[:, 12], qpos[:, 15] = np.cos(yaw / 2), np.sin(yaw / 2)
    qvel = np.zeros((B, 15), np.float32)
    qvel[:, :7] = 0.1 * rng.standard_normal((B, 7))
    return qpos, qvel


@pytest.fixture(scope="module")
def envs():
    import robosuite_tpu
    import robosuite_tpu_torch
    from robosuite_tpu.ops.pallas_substep import make_fused_substep

    jenv = robosuite_tpu.make("Lift", robots="Panda", cube_size=CUBE, reward_shaping=True)
    penv = robosuite_tpu_torch.make("Lift", robots="Panda", cube_size=CUBE, reward_shaping=True, device="cpu")
    return jenv, penv, jax.jit(make_fused_substep(jenv, jenv.model))


def test_substep_matches_jax(envs):
    jenv, penv, jfused = envs
    jm, pm = jenv.model, penv.model
    rng = np.random.default_rng(0)
    B = 3
    qpos, qvel = contact_states(rng, B)
    q, qd = torch.as_tensor(qpos), torch.as_tensor(qvel)
    kin, _, _ = forward.forward_products(pm, q, qd)
    eef = penv.robots[0].eef_site_id["right"]
    # goal: 2 cm from the current grip site, rotated by a small random angle
    goal_pos = kin.site_xpos[:, eef].numpy() + 0.02 * rng.standard_normal((B, 3)).astype(np.float32)
    ang = 0.1 * rng.standard_normal((B, 3))
    from scipy.spatial.transform import Rotation

    goal_ori = (Rotation.from_rotvec(ang).as_matrix() @ kin.site_xmat[:, eef].numpy()).astype(np.float32)
    goal = np.concatenate([goal_pos, goal_ori.reshape(B, 9)], axis=1)
    gains = np.tile(np.concatenate([np.full(6, 150.0), np.full(6, 2 * np.sqrt(150.0))]), (B, 1)).astype(np.float32)
    grip = np.tile(np.array([0.02, -0.02], np.float32), (B, 1))

    fused = substep.make_fused_substep(penv, pm)
    leaves = forward.runtime_leaves(pm, B)
    qp_p, qv_p, f_p = fused(q, qd, *leaves, torch.as_tensor(goal), torch.as_tensor(gains), torch.as_tensor(grip))
    assert substep.make_fused_substep.launches == 0  # CPU tensors never reach the kernel
    for b in range(B):
        qp_j, qv_j, f_j = jfused(jnp.asarray(qpos[b]), jnp.asarray(qvel[b]), jm.body_mass, jm.body_inertia,
                                 jm.gravity, jm.dof_armature, jnp.asarray(goal[b]), jnp.asarray(gains[b]),
                                 jnp.asarray(grip[b]))
        np.testing.assert_allclose(qp_p[b].numpy(), np.asarray(qp_j), rtol=0, atol=1e-5)
        np.testing.assert_allclose(qv_p[b].numpy(), np.asarray(qv_j), rtol=0, atol=1e-4)
        assert f_p.shape[1] == np.asarray(f_j).shape[0]


def test_unsupported_variants_raise(envs, monkeypatch):
    """JOINT_POSITION is ported: a Lift env with that arm controller builds
    the fused substep with and without emit_aux, with its goal/gains
    widths (na, 2 na). An arm controller other than OSC or JOINT_POSITION
    still makes the fused substep (with or without emit_aux) raise
    UnsupportedFused."""
    import robosuite_tpu_torch

    _, penv, _ = envs
    jp_env = robosuite_tpu_torch.make("Lift", robots="Panda", cube_size=CUBE, controller_configs="JOINT_POSITION",
                                      device="cpu")
    spec = substep.extract_spec(jp_env, jp_env.model)
    assert spec["ctrl_type"] == "joint_pos" and len(spec["qv_idx"]) == 7
    for emit_aux in (False, True):
        assert callable(substep.make_fused_substep(jp_env, jp_env.model, emit_aux=emit_aux))
        assert jp_env._fused_for(jp_env.model, emit_aux=emit_aux) is not None
    monkeypatch.setitem(penv.robots[0].arm_cfg, "right", object())
    for emit_aux in (False, True):
        with pytest.raises(substep.UnsupportedFused):
            substep.make_fused_substep(penv, penv.model, emit_aux=emit_aux)
