"""K1's plain version (ops/forward.forward_plain, what the wrapper runs on
CPU tensors) against the JAX package's make_forward_solver called
unbatched (its _xla reference path) on the identical world and states.
Bounds: poses 2e-5, mass matrix and bias 1e-4 (README parity table)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robosuite_tpu_torch import convert
from robosuite_tpu_torch.models import model as PM
from robosuite_tpu_torch.ops import forward

CUBE = [0.021, 0.021, 0.021]
INIT = np.array([0, np.pi / 16.0, 0.00, -np.pi / 2.0 - np.pi / 3.0, 0.00, np.pi - 0.2, np.pi / 4])


def lift_states(rng, B):
    """Arm near its init pose, cube resting on the table (0.8 mm deep)
    with a random yaw; small random velocities."""
    qpos = np.zeros((B, 16), np.float32)
    qpos[:, :7] = INIT + 0.2 * rng.standard_normal((B, 7))
    qpos[:, 7:9] = [0.02, -0.02]
    yaw = rng.uniform(0, 2 * np.pi, B)
    qpos[:, 9:11] = rng.uniform(-0.03, 0.03, (B, 2))
    qpos[:, 11] = 0.8 + CUBE[2] - 0.0008
    qpos[:, 12], qpos[:, 15] = np.cos(yaw / 2), np.sin(yaw / 2)
    qvel = np.zeros((B, 15), np.float32)
    qvel[:, :7] = 0.1 * rng.standard_normal((B, 7))
    qvel[:, 9:15] = 0.01 * rng.standard_normal((B, 6))
    return qpos, qvel


@pytest.fixture(scope="module")
def setup():
    import robosuite_tpu
    from robosuite_tpu.ops.pallas_forward import make_forward_solver

    jm = robosuite_tpu.make("Lift", robots="Panda", cube_size=CUBE, reward_shaping=True).model
    pm = convert.model_from_numpy({n: np.asarray(getattr(jm, n)) for n in PM.LEAVES},
                                  {n: getattr(jm, n) for n in PM.STATIC}, device="cpu")
    fp = jax.jit(make_forward_solver(jm))
    return jm, pm, fp


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_products_match_jax(setup, seed):
    jm, pm, fp = setup
    qpos, qvel = lift_states(np.random.default_rng(seed), 3)
    kin_p, M_p, bias_p = forward.forward_products(pm, torch.as_tensor(qpos), torch.as_tensor(qvel))
    for b in range(qpos.shape[0]):
        kin_j, M_j, bias_j = fp(jnp.asarray(qpos[b]), jnp.asarray(qvel[b]), jm.body_mass, jm.body_inertia,
                                jm.gravity, jm.dof_armature)
        for name in ("xpos", "xquat", "xmat", "xipos", "ximat", "sdof_ang", "sdof_lin",
                     "geom_xpos", "geom_xmat", "site_xpos", "site_xmat"):
            np.testing.assert_allclose(getattr(kin_p, name)[b].numpy(), np.asarray(getattr(kin_j, name)),
                                       rtol=0, atol=2e-5, err_msg=name)
        np.testing.assert_allclose(M_p[b].numpy(), np.asarray(M_j), rtol=0, atol=1e-4)
        np.testing.assert_allclose(bias_p[b].numpy(), np.asarray(bias_j), rtol=0, atol=1e-4)


def test_runtime_inertial_leaves(setup):
    """mass / inertia / gravity / armature are per-scenario inputs."""
    jm, pm, fp = setup
    rng = np.random.default_rng(2)
    qpos, qvel = lift_states(rng, 1)
    mass = np.asarray(jm.body_mass) * (1.0 + 0.1 * rng.random(pm.nbody)).astype(np.float32)
    arma = np.asarray(jm.dof_armature) * 2.0
    grav = np.array([0.0, 0.5, -9.0], np.float32)
    _, M_p, bias_p = forward.forward_products(
        pm, torch.as_tensor(qpos), torch.as_tensor(qvel), torch.as_tensor(mass)[None],
        pm.body_inertia[None], torch.as_tensor(grav)[None], torch.as_tensor(arma)[None])
    _, M_j, bias_j = fp(jnp.asarray(qpos[0]), jnp.asarray(qvel[0]), jnp.asarray(mass), jm.body_inertia,
                        jnp.asarray(grav), jnp.asarray(arma))
    np.testing.assert_allclose(M_p[0].numpy(), np.asarray(M_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(bias_p[0].numpy(), np.asarray(bias_j), rtol=0, atol=1e-4)
