"""One policy step of Lift-Tiago (BASIC: two OSC arms, the torso and head
JOINT_POSITION parts, the base's joint velocities; 138 candidate pairs
compacted into 96 slots) in the port against the JAX package:
tests/test_torch_mobile_robots.py's hold_step (its docstring gives the
tolerances), in a module of its own for the time it takes (the JAX step's
pieces compile for about a minute at nv 36).
"""

import pytest
import torch

from tests.test_torch_mobile_robots import hold_step


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tiago_step_matches_jax():
    hold_step("Tiago")
