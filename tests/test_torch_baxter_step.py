"""One policy step of the bimanual Baxter's worlds, Lift and TwoArmLift in
the "single-robot" configuration: the port's step_batch on the CPU (its
plain unfused path: the forward products, both arms' OSC laws and Rethink
grippers adding into one ctrl vector, the narrowphase over 351 or 761
candidate pairs, the row compaction into 96 slots, the contact solve)
against the JAX package's step, from a JAX state injected into the port
(convert.numpy_tree / state_from_numpy: two arms' controller states),
with tests/test_torch_robots_step.hold_step: the goals, each substep from
the same input, the observations (robot0_left_eef_force and _torque
among them, zero: the worlds compact their rows, as in the JAX package)
and the reward, at that module's tolerances.

The step runs at 500 Hz control (one substep; both packages' envs made
with control_freq=500): the JAX reference solves each scenario's
contacts eagerly at nv 24 (XLA:CPU compiles its unrolled Choleskys for
minutes), about 5 s a solve.
"""

import pytest
import torch

from tests.test_torch_robots_step import hold_step


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("key", ["Lift-Baxter", "TwoArmLift-Baxter"])
def test_step_batch_matches_jax(key):
    hold_step(key, 500)
