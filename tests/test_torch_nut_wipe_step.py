"""One substep and one policy step of NutAssemblySingle (Panda, OSC_POSE)
and Wipe (Panda with the wiping gripper, the variable_kp OSC, 4 markers,
seed 1): the port's plain unfused path (forward products, the
narrowphase, the row compaction into 96 slots, the contact solve) against
the JAX package's on the CPU, from chip_smoke.py's contact states
(ab_kernels.nut_contact_state: the gripper closed on the square nut's
handle; ab_kernels.wipe_contact_state: the wiping face pressed 1 mm into
the table over the markers).

  * one substep of engine.step at B=2 under random arm torques (the
    gripper's ctrl at its closing command): qpos 1e-5, qvel 1e-4;
  * one policy step of rollout_batch from the state injected into both
    (state_from_flattened), random OSC deltas (NutAssembly's gripper
    closing; Wipe's six gains drawn in [50, 250]): qpos, qvel and the
    reward 1e-4, the carried OSC goal 1e-5 (and Wipe's kp, kd); step_batch
    from the same state lands on the same physics; Wipe's step hook (the
    reward, the wiped markers, the unsafe count, done and the info keys)
    against the JAX Wipe._step_impl's pieces on the JAX post-step state
    (1e-4).

The JAX reference runs engine.step's own parts (forward_products,
_total_smooth_force, narrowphase, _solver_inputs_impl, then the contact
solve _vel_update_xla and _integrate_qpos), vmapped over the scenarios and
jitted (XLA:CPU compiles the solve's unrolled Choleskys in about 25 s at
NutAssembly's nv 21, in seconds at Wipe's nv 7). The policy step runs at
100 Hz control (5 substeps, both packages' envs made with
control_freq=100): the goals, the substeps and the reward of the 20 Hz
step, a fifth of the substeps.
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

from tests.test_torch_wipe import jax_wipe_hook, wipe_kw

STATE_FN = {"NutAssemblySingle": ab_kernels.nut_contact_state, "Wipe": ab_kernels.wipe_contact_state}


def make_kw(name):
    kw = wipe_kw() if name == "Wipe" else dict(robots="Panda", reward_shaping=True)
    return dict(kw, control_freq=100)


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

    jenv = robosuite_tpu.make(name, **make_kw(name))
    penv = robosuite_tpu_torch.make(name, device="cpu", **make_kw(name))
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
    solve = jax.jit(jax.vmap(lambda *a: JPC._vel_update_xla(*a, K, 0, JC.APGD_ITERS, JC.POWER_ITERS,
                                                            jm.timestep)[0]))

    def substep(phys, ctrl):
        qvel = solve(*pre(phys, ctrl))
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
    """engine.step (K1's plain version, the narrowphase, the compaction,
    K2's plain version) from the contact state under random arm torques,
    the gripper's ctrl at its closing command: qpos 1e-5, qvel 1e-4 in
    each scenario."""
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
    """rollout_batch from the state injected into both, random OSC deltas:
    qpos, qvel and the reward 1e-4, the carried OSC goal position (and
    Wipe's gains) 1e-5; step_batch's physics equal rollout_batch's, its
    reward rollout_batch's (NutAssembly) or, on Wipe, the step hook's
    against the JAX pieces on the JAX post-step state (1e-4)."""
    jenv, penv, flat, pieces = setup(name)
    rng = np.random.default_rng(13)
    a = np.clip(0.5 * rng.standard_normal((2, penv.action_dim)), -1.0, 1.0).astype(np.float32)
    if name == "Wipe":
        a[:, :6] = rng.uniform(50.0, 250.0, (2, 6))
    else:
        a[:, 6] = 1.0  # the gripper closing
    ps = penv.state_from_flattened(flat)
    ps2, r = penv.rollout_batch(ps, torch.as_tensor(a))
    s3, obs3, r3, done3, info3 = penv.step_batch(ps, torch.as_tensor(a))
    torch.testing.assert_close(s3.physics.qpos, ps2.physics.qpos, rtol=0, atol=0)
    if name != "Wipe":
        torch.testing.assert_close(r3, r, rtol=0, atol=0)
    js = pieces["from_flat"](jnp.asarray(flat))
    packed = pieces["goals"](js, jnp.asarray(a))
    phys = js.physics
    for _ in range(penv.n_substeps):
        phys = pieces["substep"](phys, pieces["controls"](phys, packed))
    np.testing.assert_allclose(ps2.physics.qpos.numpy(), np.asarray(phys.qpos), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ps2.physics.qvel.numpy(), np.asarray(phys.qvel), rtol=0, atol=1e-4)
    np.testing.assert_allclose(r.numpy(), np.asarray(pieces["reward"](phys)), rtol=0, atol=1e-4)
    cs_j = jenv._unpack_ctrl(packed)[0].arm["right"]
    for f in ("goal_pos", "kp", "kd"):
        np.testing.assert_allclose(getattr(ps2.ctrl.arm["right"], f).numpy(), np.asarray(getattr(cs_j, f)),
                                   rtol=0, atol=1e-5, err_msg=f)
    if name == "Wipe":
        from robosuite_tpu.physics import kinematics as JK

        assert not bool(r.any())
        hook = jax_wipe_hook(jenv)
        ts = ps.task_state if ps.task_state is not None else penv._reset_task_state(2)
        jkin = jax.jit(jax.vmap(lambda q: JK.fk(jenv.model, q)))(phys.qpos)
        for b in range(2):
            jphys = jax.tree.map(lambda x: x[b], phys)
            _, r_j, w_j, c_j, _, end_j, info_j, _ = hook(jphys, jax.tree.map(lambda x: x[b], jkin),
                                                         jnp.asarray(ts.wiped[b].numpy()), jnp.asarray(0),
                                                         jnp.asarray(0), jnp.zeros(3))
            np.testing.assert_allclose(float(r3[b]), float(r_j), rtol=0, atol=1e-4)
            assert s3.task_state.wiped[b].tolist() == np.asarray(w_j).tolist()
            assert int(s3.task_state.collisions[b]) == int(c_j) and bool(done3[b]) == bool(end_j)
            for k, v in info_j.items():
                np.testing.assert_allclose(float(info3[k][b]), float(v), rtol=0, atol=1e-4, err_msg=k)
        assert obs3["wiped_markers"].shape == (2, 4)
