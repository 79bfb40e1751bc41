"""Lift-Panda with the IK_POSE, JOINT_VELOCITY and JOINT_TORQUE arms: the
port's rollout_batch (on the CPU its plain path, unfused, as the JAX gate
runs these controllers) against the JAX package's _rollout_impl, from one
JAX state carried across with convert.numpy_tree / state_from_numpy (its
controller state too: IK's inner JOINT_POSITION state, JOINT_VELOCITY's
PID history with the bool saturation flag). The states are
tests/test_torch_substep.py's: the arm near its initial pose, moving, the
cube resting on the table (the JAX state_from_flattened). Bounds as
tests/test_torch_lift.py: one policy step qpos, qvel and reward 1e-4, the carried goals 1e-5 (IK's goal, solved in float64 by the
port, 1e-5 too: tests/test_torch_controller_parts.py), three steps arm
qpos 1e-3. Also the env's action_dim and action_limits as the JAX env's,
and the MPC built with the iLQR on every new controller.

The shared harness (`lift_pair`, `check_steps`) serves
tests/test_torch_lift_ctrl_osc.py too."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robosuite_tpu_torch import convert
from tests.test_torch_door import one_thread  # noqa: F401  (an autouse fixture: one torch thread)
from tests.test_torch_substep import contact_states

CUBE = [0.021, 0.021, 0.021]
B = 2
JOINT_CONFIGS = {"IK_POSE": "IK_POSE", "JOINT_VELOCITY": "JOINT_VELOCITY", "JOINT_TORQUE": "JOINT_TORQUE"}
_CACHE = {}


def lift_pair(name, controller, robots="Panda"):
    """(jenv, penv, jstep (the jitted JAX _rollout_impl, B scenarios one by
    one), the JAX states stacked on a batch dim): cached by name, so the JAX
    step compiles once a module."""
    import robosuite_tpu
    import robosuite_tpu_torch

    if name not in _CACHE:
        def cfg():  # the JAX factory pops "type" from the caller's dict
            return {a: dict(c) for a, c in controller.items()} if isinstance(controller, dict) else controller

        jenv = robosuite_tpu.make("Lift", robots=robots, cube_size=CUBE, reward_shaping=True, controller_configs=cfg())
        penv = robosuite_tpu_torch.make("Lift", robots=robots, cube_size=CUBE, reward_shaping=True, device="cpu",
                                        controller_configs=cfg())
        step1 = jax.jit(jenv._rollout_impl)

        def jstep(js, a):
            outs = [step1(jax.tree.map(lambda x: x[b], js), a[b]) for b in range(B)]
            return jax.tree.map(lambda *x: jnp.stack(x), *outs)

        qpos, qvel = contact_states(np.random.default_rng(7), B)
        from_flat = jax.jit(jenv.state_from_flattened)
        js = [from_flat(jnp.concatenate([jnp.zeros(1), jnp.asarray(q), jnp.asarray(v)])) for q, v in zip(qpos, qvel)]
        _CACHE[name] = (jenv, penv, jstep, jax.tree.map(lambda *x: jnp.stack(x), *js))
    return _CACHE[name]


def actions(penv, js, n, absolute=False, seed=1):
    """n policy steps of actions (B, A): small random deltas with the
    gripper closing; absolute world goals (OSC): the eef's position plus
    up to 2 cm and its orientation's axis-angle plus up to 0.05 rad."""
    rng = np.random.default_rng(seed)
    a = (0.3 * rng.standard_normal((n, B, penv.action_dim))).astype(np.float32)
    a[..., -1] = 1.0
    if absolute:
        from robosuite_tpu_torch.physics import kinematics
        from robosuite_tpu_torch.utils import transforms as T

        kin = kinematics.fk(penv.model, torch.as_tensor(np.array(js.physics.qpos)))
        site = penv.robots[0].eef_site_id["right"]
        aa = T.quat2axisangle(T.mat2quat(kin.site_xmat[:, site])).numpy()
        a[..., :3] = kin.site_xpos[:, site].numpy() + rng.uniform(-0.02, 0.02, (n, B, 3))
        a[..., 3:6] = aa + rng.uniform(-0.05, 0.05, (n, B, 3))
    return a


def carry(js):
    """The JAX states as the port's, through numpy."""
    return convert.state_from_numpy(convert.numpy_tree(js), device="cpu")


def _arm_leaves(cs):
    tree = convert.numpy_tree(cs.arm["right"])
    out = {}

    def walk(t, p):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{p}{k}.")
            elif v is not None:
                out[p + k] = v
    walk(tree, "")
    return out


def check_steps(name, controller, absolute=False):
    """One policy step (state, reward, the carried controller state) and
    three (arm qpos) against the JAX package."""
    jenv, penv, jstep, js = lift_pair(name, controller)
    ps = carry(js)
    acts = actions(penv, js, 3, absolute)
    js1, jr = jstep(js, jnp.asarray(acts[0]))
    ps1, pr = penv.rollout_batch(ps, torch.as_tensor(acts[0]))
    np.testing.assert_allclose(ps1.physics.qpos.numpy(), np.asarray(js1.physics.qpos), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ps1.physics.qvel.numpy(), np.asarray(js1.physics.qvel), rtol=0, atol=1e-4)
    np.testing.assert_allclose(pr.numpy(), np.asarray(jr), rtol=0, atol=1e-4)
    got, want = _arm_leaves(ps1.ctrl), _arm_leaves(js1.ctrl)
    assert set(got) == set(want)
    for k, v in got.items():
        if v.dtype == bool:
            np.testing.assert_array_equal(v, want[k], err_msg=k)
        else:
            np.testing.assert_allclose(v, want[k], rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(ps1.ctrl.gripper_action["right"].numpy(), np.asarray(js1.ctrl.gripper_action["right"]),
                               rtol=0, atol=1e-6)
    for a in acts[1:]:
        js1, _ = jstep(js1, jnp.asarray(a))
        ps1, _ = penv.rollout_batch(ps1, torch.as_tensor(a))
    np.testing.assert_allclose(ps1.physics.qpos[:, :7].numpy(), np.asarray(js1.physics.qpos)[:, :7], rtol=0,
                               atol=1e-3)
    assert torch.isfinite(ps1.physics.qpos).all() and torch.isfinite(ps1.physics.qvel).all()
    return ps1


@pytest.mark.parametrize("name", list(JOINT_CONFIGS))
def test_policy_steps_match_jax(name):
    check_steps(name, JOINT_CONFIGS[name])


@pytest.mark.parametrize("name", list(JOINT_CONFIGS))
def test_action_space_and_gate_match_jax(name):
    """action_dim and action_limits as the JAX env's; the fused gate
    refuses the arm controller (UnsupportedFused, as the JAX gate does),
    so the env steps unfused."""
    from robosuite_tpu.ops import pallas_substep as JPS

    from robosuite_tpu_torch.ops import substep

    jenv, penv, _, _ = lift_pair(name, JOINT_CONFIGS[name])
    assert penv.action_dim == jenv.action_dim == {"IK_POSE": 7}.get(name, 8)
    for p, j in zip(penv.action_spec, jenv.action_spec):
        np.testing.assert_array_equal(p, np.asarray(j))
    with pytest.raises(JPS.UnsupportedFused, match="arm controller"):
        JPS.extract_spec(jenv, jenv.model)
    with pytest.raises(substep.UnsupportedFused, match="arm controller"):
        substep.extract_spec(penv, penv.model)
    assert penv._fused_for(penv.model) is None


def test_joint_velocity_pid_state_stays_at_zero():
    """JOINT_VELOCITY's PID history is dropped at every substep, as the JAX
    package drops it (its run_controllers keeps no new state): after a step
    the carried state's history is init_state's zeros."""
    _, penv, _, js = lift_pair("JOINT_VELOCITY", "JOINT_VELOCITY")
    ps = carry(js)
    ps1, _ = penv.rollout_batch(ps, torch.ones(B, penv.action_dim))
    st = ps1.ctrl.arm["right"]
    assert float(st.goal_vel.abs().min()) == 1.0  # output_max 1 (the JAX factory's)
    for leaf in (st.last_err, st.derr_buf, st.summed_err):
        assert float(leaf.abs().max()) == 0.0
    assert st.saturated.dtype == torch.bool and not bool(st.saturated.any())


@pytest.mark.parametrize("name", list(JOINT_CONFIGS))
def test_mpc_builds_with_the_ilqr(name):
    """RecedingMPC with one iLQR iteration (Lift has a residual) builds on
    the controller and one tiny tick (B=2, H=2, K=2) returns finite actions
    in [-1, 1]: the iLQR state x (qpos, qvel, the gripper ramp) leaves the
    arm state to the template, whose leaves (the bool saturation flag too)
    expand to the sweep's width."""
    from robosuite_tpu_torch.mpc import receding

    _, penv, _, js = lift_pair(name, JOINT_CONFIGS[name])
    cfg = receding.MPCConfig(horizon=2, n_samples=2, n_knots=2, n_ilqr_iters=1, plan_timestep=0.025,
                             plan_pair_points=2, fd_timestep=0.05)
    mpc = receding.RecedingMPC(penv, cfg)
    assert mpc.nx == penv.model.nq + penv.model.nv + 2
    a, ms, met = mpc.make_solve_batch()(carry(js), mpc.init_state(B, torch.Generator().manual_seed(0)))
    assert a.shape == (B, penv.action_dim) and bool(torch.isfinite(a).all()) and float(a.abs().max()) <= 1.0
    assert met["ilqr_accepted"].shape == (B,)
