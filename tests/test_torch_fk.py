"""The plain versions of the port's K4 (ops/fk.fk_pose_plain, the pose-only
FK) and of K3's emit_aux variant (ops/substep.substep_aux_plain), which the
wrappers run on CPU tensors, against the JAX package: K4 against
make_fk_kernel in interpret mode on the Lift world at B=128 (2e-5, with
sign-aligned quaternions as tests/test_pallas_fk.py holds it), K3-aux
against make_fused_substep(..., emit_aux=True) called unbatched on the
2-point planning model (qpos 1e-5, qvel 1e-4, poses 2e-5, pair distances
1e-5). Also Model.replace: the planning model's row layout is the JAX
package's, and it shares buffers but no kernel tables."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robosuite_tpu_torch.ops import fk, forward, substep
from robosuite_tpu_torch.physics import contact as C
from tests.test_torch_substep import CUBE, contact_states
from tests.test_torch_door import one_thread  # noqa: F401  (an autouse fixture: one torch thread)

PLAN = dict(timestep=0.025, solver_iters=10, pair_points_cap=2)


@pytest.fixture(scope="module")
def envs():
    import robosuite_tpu
    import robosuite_tpu_torch

    jenv = robosuite_tpu.make("Lift", robots="Panda", cube_size=CUBE, reward_shaping=True)
    penv = robosuite_tpu_torch.make("Lift", robots="Panda", cube_size=CUBE, reward_shaping=True, device="cpu")
    return jenv, penv


def test_replace_row_layout_and_buffers(envs):
    from robosuite_tpu.physics import contact as JC

    jenv, penv = envs
    pm = penv.model
    forward.model_tables(pm)  # the execution model's packed tables, cached on it
    plan = pm.replace(**PLAN)
    assert C.contact_row_layout(plan) == JC.contact_row_layout(jenv.model.replace(**PLAN))
    assert sum(len(r) for r in C.contact_row_layout(plan).values()) == 36
    assert C.contact_row_layout(pm) == JC.contact_row_layout(jenv.model)
    assert "_kernel_tables" in pm.__dict__ and "_kernel_tables" not in plan.__dict__
    assert plan.body_mass.data_ptr() == pm.body_mass.data_ptr()
    assert (plan.timestep, plan.solver_iters, plan.solver_power_iters) == (0.025, 10, None)
    assert C.solver_iterations(plan) == (10, C.POWER_ITERS)
    with pytest.raises(ValueError):
        pm.replace(body_mass=None)


def test_fk_pose_plain_matches_pallas_fk(envs):
    from robosuite_tpu.ops.pallas_fk import make_fk_kernel

    jenv, penv = envs
    B = 128
    rng = np.random.default_rng(0)
    qpos, _ = contact_states(rng, B)
    qpos[:, 9:12] += rng.uniform(-0.2, 0.2, (B, 3)).astype(np.float32)
    q = rng.normal(size=(B, 4)).astype(np.float32)
    qpos[:, 12:16] = q / np.linalg.norm(q, axis=1, keepdims=True)
    xpos_j, xquat_j = make_fk_kernel(jenv.model, interpret=True)(jnp.asarray(qpos))
    xpos_p, xquat_p = fk.fk_pose(penv.model, torch.as_tensor(qpos))
    assert fk.fk_pose.launches == 0  # CPU tensors never reach the kernel
    np.testing.assert_allclose(xpos_p.numpy(), np.asarray(xpos_j), rtol=0, atol=2e-5)
    xq, rq = xquat_p.numpy(), np.asarray(xquat_j)
    flip = np.sign(np.sum(xq * rq, axis=-1, keepdims=True))
    np.testing.assert_allclose(xq * flip, rq, rtol=0, atol=2e-5)


def test_substep_aux_plain_matches_jax(envs):
    from robosuite_tpu.ops.pallas_substep import make_fused_substep

    jenv, penv = envs
    jplan, pplan = jenv.model.replace(**PLAN), penv.model.replace(**PLAN)
    rng = np.random.default_rng(1)
    B = 3
    qpos, qvel = contact_states(rng, B)
    q, qd = torch.as_tensor(qpos), torch.as_tensor(qvel)
    kin, _, _ = forward.forward_products(pplan, q, qd)
    eef = penv.robots[0].eef_site_id["right"]
    goal = np.concatenate([kin.site_xpos[:, eef].numpy() + 0.02 * rng.standard_normal((B, 3)).astype(np.float32),
                           kin.site_xmat[:, eef].reshape(B, 9).numpy()], axis=1)
    gains = np.tile(np.concatenate([np.full(6, 150.0), np.full(6, 2 * np.sqrt(150.0))]), (B, 1)).astype(np.float32)
    grip = np.tile(np.array([0.02, -0.02], np.float32), (B, 1))

    fused = substep.make_fused_substep(penv, pplan, emit_aux=True)
    leaves = forward.runtime_leaves(pplan, B)
    out_p = fused(q, qd, *leaves, torch.as_tensor(goal), torch.as_tensor(gains), torch.as_tensor(grip))
    assert substep.make_fused_substep.aux_launches == 0
    jfused = jax.jit(make_fused_substep(jenv, jplan, emit_aux=True))
    names = ("qpos", "qvel", "f", "site_xpos", "site_xmat", "xpos", "pair_dist")
    tols = dict(qpos=1e-5, qvel=1e-4, site_xpos=2e-5, site_xmat=2e-5, xpos=2e-5, pair_dist=1e-5)
    for b in range(B):
        out_j = jfused(jnp.asarray(qpos[b]), jnp.asarray(qvel[b]), jplan.body_mass, jplan.body_inertia,
                       jplan.gravity, jplan.dof_armature, jnp.asarray(goal[b]), jnp.asarray(gains[b]),
                       jnp.asarray(grip[b]))
        for name, p, j in zip(names, out_p, out_j):
            assert p[b].shape == np.asarray(j).shape, name
            if name in tols:
                np.testing.assert_allclose(p[b].numpy(), np.asarray(j), rtol=0, atol=tols[name], err_msg=name)
    # the states touch: the cube rests on the table, 1.2 mm deep
    assert float(out_p[-1].min()) < 0.0
