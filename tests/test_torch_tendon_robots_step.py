"""One policy step of Lift-IIWA (4 tendon equalities, 122 static rows) and
Lift-XArm7 (2 connects and a joint coupling, a `general` servo on a
tendon) in the port against the JAX package, with the observations and
the reward: tests/test_torch_tendon_robots.py's hold_step (its docstring
gives the tolerances), in a module of its own for the time it takes.
"""

import pytest
import torch

from tests.test_torch_tendon_robots import hold_step


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("robot", ["IIWA", "XArm7"])
def test_step_batch_and_observations_match_jax(robot):
    hold_step(robot, observations=True)
