"""One policy step of Lift-GR1 itself (WHOLE_BODY_IK over the torso and
both arms, the 12 legs held at the card's stance, the Fourier hands; nv
60, 558 candidate pairs compacted into 96 slots) in the port against the
JAX package: tests/test_torch_mobile_robots.py's hold_step, with the
observations and the reward; a scenario whose substep keeps other contact
points on GR1's head-roll box in its chest than the JAX step (an exact SAT tie)
is held by hold_substep_on_tie, as in
tests/test_torch_gr1_floating_step.py. Marked slow: the JAX reference
(its step's pieces compiled, its contact solve eager at nv 60) takes
100-160 s on one worker, more than the narrower GR1 variants' steps
that cover the same code; run it with `-m slow` when GR1's path changes.
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


@pytest.mark.slow
def test_gr1_step_matches_jax():
    witnesses = hold_step("GR1", observations=True, ties=True)
    assert all("tie" in w for w in witnesses)
