"""One substep and one policy step of TwoArmLift and TwoArmPegInHole with
two Pandas and OSC_POSE: the port's plain unfused path (forward products,
the narrowphase, TwoArmLift's row compaction into 96 slots or
TwoArmPegInHole's 117 static rows, the contact solve; both robots'
controllers adding into one ctrl vector) against the JAX package's on
the CPU, from chip_smoke.py's contact states (ab_kernels.
twoarm_lift_contact_state: both grippers closed on the pot's handles;
ab_kernels.peg_contact_state: the peg's tip pressed into a side of the
hole's mouth).

  * one substep of engine.step at B=2 under random arm torques on both
    arms: qpos 1e-5, qvel 1e-4 (as tests/test_torch_pickplace_step.py);
  * one policy step of rollout_batch from the state injected into both
    (state_from_flattened), random OSC deltas on both arms (TwoArmLift's
    grippers closing): qpos, qvel and the reward 1e-4, each robot's
    carried OSC goal 1e-5; step_batch from the same state lands on the
    same physics and reward.

The JAX reference runs engine.step's own parts (forward_products,
_total_smooth_force, narrowphase, _solver_inputs_impl, then the contact
solve _vel_update_xla and _integrate_qpos), vmapped over the scenarios:
all jitted but TwoArmLift's solve, which runs eagerly (XLA:CPU takes a
minute on its unrolled Choleskys at nv 24, seconds at TwoArmPegInHole's nv
14). For the same reason the policy step runs at 100 Hz control (5
substeps, both packages' envs made with control_freq=100): the goals, the
substeps and the reward of the 20 Hz step, a fifth of the substeps.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robosuite_tpu_torch import ab_kernels
from robosuite_tpu_torch.physics import contact as C
from robosuite_tpu_torch.physics import engine
from robosuite_tpu_torch.physics.state import State

KW = dict(robots=("Panda", "Panda"), reward_shaping=True, control_freq=100)
STATE_FN = {"TwoArmLift": ab_kernels.twoarm_lift_contact_state, "TwoArmPegInHole": ab_kernels.peg_contact_state}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_SETUP = {}


def setup(name):
    """(jenv, penv, flat (2, 1 + nq + nv) of the contact state, the JAX
    pieces, each vmapped over the scenarios: `substep` (engine.step's
    parts), `goals`, `controls`, `reward`, `from_flat`), made once per
    world."""
    if name in _SETUP:
        return _SETUP[name]
    import robosuite_tpu
    import robosuite_tpu_torch
    from robosuite_tpu.ops import pallas_contact as JPC
    from robosuite_tpu.physics import contact as JC
    from robosuite_tpu.physics import engine as JE
    from robosuite_tpu.physics.state import State as JState

    jenv = robosuite_tpu.make(name, **KW)
    penv = robosuite_tpu_torch.make(name, device="cpu", **KW)
    assert jenv.n_substeps == penv.n_substeps == 5
    s, _ = penv.reset_batch(2, torch.Generator().manual_seed(11))
    s = STATE_FN[name](penv, s)
    flat = torch.cat([s.physics.time[:, None], s.physics.qpos, s.physics.qvel], 1).numpy()
    jm = jenv.model
    rows = JC.contact_row_layout(jm)
    nrows = sum(len(r) for r in rows.values())
    K = min(JC.ROW_CAP, nrows) if JC.uses_row_compaction(jm) else nrows

    def before_solve(phys, ctrl):
        kin, M, bias = JE.forward_products(jm, phys)
        qfrc, extra = JE._total_smooth_force(jm, phys, ctrl, kin, bias, M)
        con = JC.narrowphase(jm, kin)
        return JC._solver_inputs_impl(jm, kin, con, M, phys.qvel, qfrc, jm.timestep, None,
                                      jm.dof_damping + extra)[0]

    pre = jax.jit(jax.vmap(before_solve))
    post = jax.jit(jax.vmap(lambda q, v: JE._integrate_qpos(jm, q, v, jm.timestep)))
    solve = lambda *a: JPC._vel_update_xla(*a, K, 0, JC.APGD_ITERS, JC.POWER_ITERS, jm.timestep)[0]  # noqa: E731
    if jm.nv <= 16:  # XLA:CPU compiles the solve at nv 14 in seconds (at nv 24 in a minute)
        solve = jax.jit(solve)

    def substep(phys, ctrl):
        args = pre(phys, ctrl)
        with jax.disable_jit(jm.nv > 16):  # each scenario's solve unbatched
            qvel = jnp.stack([solve(*(x[b] for x in args)) for b in range(phys.qpos.shape[0])])
        return JState(qpos=post(phys.qpos, qvel), qvel=qvel, time=phys.time + jm.timestep)

    def goals(state, action):
        phys = state.physics
        kin, M, bias = JE.forward_products(jm, phys)
        cs = jenv._unpack_ctrl(state.ctrl)
        cs = [r.set_goals(kin, M, bias, phys.qpos, phys.qvel, c, a)
              for r, c, a in zip(jenv.robots, cs, jenv._split_robot_actions(jnp.clip(action, *jenv._action_clip)))]
        return jenv._pack_ctrl(cs)

    def controls(phys, packed):
        kin, M, bias = JE.forward_products(jm, phys)
        ctrl = jnp.zeros(jm.nu, dtype=phys.qpos.dtype)
        for r, c in zip(jenv.robots, jenv._unpack_ctrl(packed)):
            ctrl = r.run_controllers(kin, M, bias, phys.qpos, phys.qvel, c, ctrl)
        return ctrl

    assert C.contact_row_layout(penv.model) == rows
    pieces = dict(substep=substep, goals=jax.jit(jax.vmap(goals)), controls=jax.jit(jax.vmap(controls)),
                  reward=jax.jit(jax.vmap(lambda phys: jenv.reward(None, phys, JE.forward_products(jm, phys)[0]))),
                  from_flat=jax.jit(jax.vmap(jenv.state_from_flattened)))
    _SETUP[name] = jenv, penv, flat, pieces
    return _SETUP[name]


@pytest.mark.parametrize("name", list(STATE_FN))
def test_substep_matches_jax(name):
    """engine.step (K1's plain version, the narrowphase, the compaction or
    the static rows, K2's plain version) from the contact state under
    random torques on both arms, the grippers' ctrl at their closing
    command: qpos 1e-5, qvel 1e-4 in each scenario."""
    from robosuite_tpu.physics.state import State as JState

    _, penv, flat, pieces = setup(name)
    pm = penv.model
    rng = np.random.default_rng(12)
    ctrl = np.zeros((2, pm.nu), np.float32)
    for robot in penv.robots:
        ctrl[:, robot.arm_actuator_ids["right"]] = rng.uniform(-5.0, 5.0, (2, 7))
        ctrl[:, robot.gripper_actuator_ids["right"]] = [0.02, -0.02][:len(robot.gripper_actuator_ids["right"])]
    q, qd = flat[:, 1:1 + pm.nq], flat[:, 1 + pm.nq:]
    out = engine.step(pm, State(qpos=torch.as_tensor(q), qvel=torch.as_tensor(qd), time=torch.zeros(2)),
                      torch.as_tensor(ctrl))
    js = pieces["substep"](JState(qpos=jnp.asarray(q), qvel=jnp.asarray(qd), time=jnp.zeros(2)), jnp.asarray(ctrl))
    np.testing.assert_allclose(out.qpos.numpy(), np.asarray(js.qpos), rtol=0, atol=1e-5)
    np.testing.assert_allclose(out.qvel.numpy(), np.asarray(js.qvel), rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", list(STATE_FN))
def test_one_policy_step_matches_jax(name):
    """rollout_batch from the state injected into both, random OSC deltas
    on both arms: qpos, qvel and the reward 1e-4, each robot's carried
    OSC goal position 1e-5; step_batch's physics and reward equal
    rollout_batch's."""
    jenv, penv, flat, pieces = setup(name)
    rng = np.random.default_rng(13)
    a = np.clip(0.5 * rng.standard_normal((2, penv.action_dim)), -1.0, 1.0).astype(np.float32)
    if name == "TwoArmLift":
        a[:, [6, 13]] = 1.0  # both grippers closing
    ps = penv.state_from_flattened(flat)
    ps2, r = penv.rollout_batch(ps, torch.as_tensor(a))
    s3, _, r3, _, _ = penv.step_batch(ps, torch.as_tensor(a))
    torch.testing.assert_close(s3.physics.qpos, ps2.physics.qpos, rtol=0, atol=0)
    torch.testing.assert_close(r3, r, rtol=0, atol=0)
    js = pieces["from_flat"](jnp.asarray(flat))
    packed = pieces["goals"](js, jnp.asarray(a))
    phys = js.physics
    for _ in range(penv.n_substeps):
        phys = pieces["substep"](phys, pieces["controls"](phys, packed))
    np.testing.assert_allclose(ps2.physics.qpos.numpy(), np.asarray(phys.qpos), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ps2.physics.qvel.numpy(), np.asarray(phys.qvel), rtol=0, atol=1e-4)
    np.testing.assert_allclose(r.numpy(), np.asarray(pieces["reward"](phys)), rtol=0, atol=1e-4)
    for cs_p, cs_j in zip(ps2.ctrl, jenv._unpack_ctrl(packed)):
        np.testing.assert_allclose(cs_p.arm["right"].goal_pos.numpy(), np.asarray(cs_j.arm["right"].goal_pos),
                                   rtol=0, atol=1e-5)
