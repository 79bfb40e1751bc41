"""One policy step of Lift-Tiago under default_tiago_whole_body_ik.json in
the port against the JAX package: tests/test_torch_wbik.py's step test
(its docstring gives the tolerances and the JAX robot's arm widths), in a
module of its own for the time it takes (the JAX step's pieces compile
for about a minute at nv 36).
"""

import pytest
import torch

from tests.test_torch_mobile_robots import hold_step
from tests.test_torch_wbik import CFG, targets


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tiago_wbik_step_matches_jax():
    hold_step("Tiago", CFG["Tiago"], action=targets("Tiago", 50))
