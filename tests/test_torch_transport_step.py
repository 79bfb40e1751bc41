"""One substep, one policy step and one MPPI-only solve of TwoArmTransport
(two Pandas, OSC_POSE; nv 36, 250 pairs, 905 rows compacted into 96 slots)
on the port's plain unfused path against the JAX package's on the CPU,
from chip_smoke.py's contact state (ab_kernels.transport_contact_state:
the payload in the start bin under the lid, the trash on table 0, robot0's
pads closed on the lid's handle), over the harness of
tests/test_torch_last_envs_step.py (its docstring gives the JAX side, its
contact solve eager at nv 36, and the tolerances): the substep's qpos and
qvel 1e-5; the policy step's qpos, reward and OSC goals 1e-5, qvel 1e-4;
the MPPI solve's actions and shifted plans 1e-4.
"""

import numpy as np

from tests.test_torch_last_envs_step import hold_mppi_solve, hold_policy_step, hold_substep, one_thread  # noqa: F401


def test_substep_matches_jax():
    hold_substep("TwoArmTransport")


def test_one_policy_step_matches_jax():
    hold_policy_step("TwoArmTransport")


def test_mppi_solve_matches_jax():
    """The shaped returns (the lid, the payload's and the trash's
    distances to their bins) weigh the samples."""
    assert np.isfinite(hold_mppi_solve("TwoArmTransport")).all()
