"""The port's Lift-Panda world compile equals the JAX package's compile_spec,
leaf by leaf (integers and names exactly, floats within 1e-6)."""

import numpy as np
import pytest

from robosuite_tpu_torch import convert
from robosuite_tpu_torch.models import model as PM

CUBE = [0.021, 0.021, 0.021]


@pytest.fixture(scope="module")
def worlds():
    import robosuite_tpu
    import robosuite_tpu_torch

    jax_env = robosuite_tpu.make("Lift", robots="Panda", cube_size=CUBE, reward_shaping=True)
    port_env = robosuite_tpu_torch.make("Lift", robots="Panda", cube_size=CUBE, reward_shaping=True, device="cpu")
    return jax_env.model, port_env.model


def _static(v):
    return tuple(v) if isinstance(v, (list, tuple)) else v


@pytest.mark.parametrize("name", PM.LEAVES)
def test_leaf_matches(worlds, name):
    jm, pm = worlds
    a = np.asarray(getattr(jm, name), dtype=np.float64)
    b = getattr(pm, name).numpy().astype(np.float64)
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


def test_static_structure_matches(worlds):
    jm, pm = worlds
    for name in PM.STATIC:
        assert _static(getattr(pm, name)) == _static(getattr(jm, name)), name


def test_lift_world_sizes(worlds):
    _, pm = worlds
    assert (pm.nq, pm.nv, pm.nbody, pm.ngeom, pm.nsite, pm.nu, pm.npair) == (16, 15, 26, 90, 9, 9, 18)


def test_model_from_numpy_roundtrip(worlds):
    jm, pm = worlds
    leaves = {n: np.asarray(getattr(jm, n)) for n in PM.LEAVES}
    meta = {n: getattr(jm, n) for n in PM.STATIC}
    m2 = convert.model_from_numpy(leaves, meta, device="cpu")
    for n in PM.LEAVES:
        np.testing.assert_allclose(getattr(m2, n).numpy(), getattr(pm, n).numpy(), rtol=0, atol=1e-6)
    assert m2.body_names == pm.body_names and m2.pair_geom1 == pm.pair_geom1
