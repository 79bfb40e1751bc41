"""One policy step of Lift-GR1ArmsOnly (WHOLE_BODY_IK over the two arms,
the Fourier hands' 6-wide actions onto their 11 actuators, 311 candidate
pairs compacted into 96 slots) in the port against the JAX package:
tests/test_torch_mobile_robots.py's hold_step (its docstring gives the
tolerances), with the observations and the reward, in a module of its
own for the time it takes (the JAX step's pieces compile for about a
minute, and its contact solve runs eagerly at nv 42).
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


def test_gr1_arms_only_step_matches_jax():
    hold_step("GR1ArmsOnly", observations=True)
