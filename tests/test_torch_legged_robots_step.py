"""One policy step of Lift-SpotWithArmFloating (the planar base's velocity
actuators, the rigid legs) in the port against the JAX package:
tests/test_torch_mobile_robots.py's hold_step (its docstring gives the
tolerances), in a module of its own for the time it takes.
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


def test_spotwitharmfloating_step_matches_jax():
    hold_step("SpotWithArmFloating", observations=True)
