"""One substep, one policy step and one MPPI-only solve of ToolHang (a
Panda, OSC_POSE) on the port's plain unfused path against the JAX
package's on the CPU, from chip_smoke.py's contact state
(ab_kernels.tool_hang_contact_state: the stand, the frame and the wrench at
rest on the table, the pads closed on the wrench's bar), over the harness
of tests/test_torch_last_envs_step.py (its docstring gives the JAX side
and the tolerances): the substep's qpos and qvel 1e-5; the policy step's
qpos, reward and OSC goal 1e-5, qvel 1e-4; the MPPI solve's actions and
shifted plans 1e-4.
"""

import numpy as np

from tests.test_torch_last_envs_step import hold_mppi_solve, hold_policy_step, hold_substep, one_thread  # noqa: F401


def test_substep_matches_jax():
    hold_substep("ToolHang")


def test_one_policy_step_matches_jax():
    """The sparse reward stays 0: no success at the grasp."""
    assert not bool(hold_policy_step("ToolHang").any())


def test_mppi_solve_matches_jax():
    """ToolHang's sparse reward leaves every planning return 0, so its plan
    is the uniform mean of the samples, in both packages."""
    means = hold_mppi_solve("ToolHang")
    assert np.isfinite(means).all()
