"""convert.state_from_numpy on the whole JAX EnvState of any env: the JAX
reset states of TwoArmLift (two robots, each its own RobotCtrlState),
Wipe (the task state, variable_kp gains) and TwoArmTransport (two robots,
nv 36), flattened with convert.numpy_tree, carried into the port, checked
leaf by leaf, then stepped once by both packages from the same state.

The JAX step is the harness of tests/test_torch_last_envs_step.py (the
env's goals, controls and substep as jitted pieces, the contact solve
eager); both envs run at 500 Hz control, so that a policy step is one
substep (the goals and a substep of the 20 Hz step). Tolerances are those
of the existing step tests: qpos 1e-5, qvel 1e-4, the carried OSC goal
positions 1e-5 (the reward of each world's step is held there). The
gripper ramps carry their JAX widths: one pad entry for a gripper with no
actuators (the JAX robot.py pads to max(n_act, 1)).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robosuite_tpu_torch import convert
from robosuite_tpu_torch.envs.wipe import WipeTaskState
from tests.test_torch_last_envs_step import jax_pieces, one_thread  # noqa: F401
from tests.test_torch_wipe import wipe_kw

WORLDS = {"TwoArmLift": lambda: dict(robots=("Panda", "Panda"), env_configuration="opposed", reward_shaping=True),
          "Wipe": wipe_kw,
          "TwoArmTransport": lambda: dict(robots=("Panda", "Panda"), reward_shaping=True)}


def _leaves(tree, prefix=""):
    """{path: array} of a numpy tree."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _leaves(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree) for k, v in _leaves(sub, f"{prefix}/{i}").items()}
    return {} if tree is None else {prefix: tree}


@pytest.mark.parametrize("name", list(WORLDS))
def test_jax_reset_state_carries_across_and_steps(name):
    import robosuite_tpu
    import robosuite_tpu_torch

    jenv = robosuite_tpu.make(name, control_freq=500, **WORLDS[name]())
    penv = robosuite_tpu_torch.make(name, device="cpu", control_freq=500, **WORLDS[name]())
    assert jenv.n_substeps == penv.n_substeps == 1
    js = jenv.reset_batch(jax.random.split(jax.random.PRNGKey(4), 2))[0]
    tree = convert.numpy_tree(js)
    ps = convert.state_from_numpy(tree, device="cpu", task_state_cls=WipeTaskState)

    # every leaf the port's state has, as the JAX state has it
    got = _leaves(convert.numpy_tree(ps))
    want = _leaves(tree)
    assert set(got) == {k for k in want if not k.startswith(("/rng", "/obs_cache"))}
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert isinstance(ps.ctrl, tuple) == (name != "Wipe")
    assert (ps.task_state is not None) == (name == "Wipe")
    # the port's own reset has the same structure and widths
    own = _leaves(convert.numpy_tree(penv.reset_batch(2, torch.Generator().manual_seed(0))[0]))
    assert {k: v.shape for k, v in own.items() if k != "/obs_cache"} == {k: v.shape for k, v in got.items()}

    rng = np.random.default_rng(14)
    a = np.clip(0.5 * rng.standard_normal((2, penv.action_dim)), -1.0, 1.0).astype(np.float32)
    if name == "Wipe":
        a[:, :6] = rng.uniform(50.0, 250.0, (2, 6))
    ps2, _ = penv.rollout_batch(ps, torch.as_tensor(a))
    pieces = jax_pieces(jenv, jenv.model)
    packed = pieces["goals"](js, jnp.asarray(a))
    phys = pieces["substep"](js.physics, pieces["controls"](js.physics, packed))
    np.testing.assert_allclose(ps2.physics.qpos.numpy(), np.asarray(phys.qpos), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ps2.physics.qvel.numpy(), np.asarray(phys.qvel), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ps2.physics.time.numpy(), np.asarray(phys.time), rtol=0, atol=1e-7)
    for cs_p, cs_j in zip(penv._unpack_ctrl(ps2.ctrl), jenv._unpack_ctrl(packed)):
        np.testing.assert_allclose(cs_p.arm["right"].goal_pos.numpy(), np.asarray(cs_j.arm["right"].goal_pos),
                                   rtol=0, atol=1e-5)
        for arm, ramp in cs_p.gripper_action.items():
            np.testing.assert_allclose(ramp.numpy(), np.asarray(cs_j.gripper_action[arm]), rtol=0, atol=1e-6)
    assert torch.equal(ps2.t, ps.t + 1)


def test_one_arm_leaves_still_carry():
    """The one-robot, one-arm form (qpos, qvel and an arm's leaves) still
    builds the state it built, with time and t at zero."""
    B = 2
    leaves = dict(goal_qpos=np.ones((B, 7)), kp=np.full((B, 7), 50.0), kd=np.full((B, 7), 14.0),
                  gripper_action=np.zeros((B, 2)))
    s = convert.state_from_numpy(np.zeros((B, 9)), np.zeros((B, 9)), leaves, device="cpu")
    assert type(s.ctrl.arm["right"]).__name__ == "JointPosState"
    assert s.ctrl.gripper_action["right"].shape == (B, 2) and s.task_state is None
    assert not s.physics.time.any() and not s.t.any() and s.t.dtype == torch.int32
