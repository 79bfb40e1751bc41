"""One policy step of Lift-GR1FloatingBody (HYBRID_MOBILE_BASE: the two
OSC arms, the torso and head JOINT_POSITION parts, the FloatingLeggedBase's
planar joints and the base-mode flag; the Fourier hands; 444 candidate
pairs compacted into 96 slots) in the port against the JAX package:
tests/test_torch_mobile_robots.py's hold_step, with the observations and
the reward, the base mode on in one scenario and off in the other. GR1's
head-roll box sits 6.5 cm deep in its chest box, and that pair's SAT axes tie
exactly (margin 0 in float64), so float32 rounding may keep other contact
points there than the JAX step keeps: such a scenario's substep is held
by hold_substep_on_tie (the float64 witness, and the port's solve and
integration on the JAX step's own solver operands at qpos 1e-5, qvel
1e-4). A module of its own for the time it takes (the JAX contact solve
runs eagerly at nv 51).
"""

import numpy as np
import pytest
import torch

from tests.test_torch_mobile_robots import hold_step


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_gr1_floating_body_step_matches_jax():
    rng = np.random.default_rng(36)
    a = np.clip(0.5 * rng.standard_normal((2, 34)), -1.0, 1.0).astype(np.float32)
    a[:, -1] = (1.0, -1.0)
    witnesses = hold_step("GR1FloatingBody", observations=True, action=a, ties=True)
    assert all("tie" in w for w in witnesses)
