"""One policy step of the new robots' fused worlds, Lift with PandaDexRH
and with SpotArm: the port's step_batch on the CPU (its plain path: the
plain fused substep with the Inspire hand's 12 gripper actuators or
SpotArm's 6-dof OSC law) against the JAX package's step, from a JAX state
injected into the port (convert.numpy_tree / state_from_numpy: the
12-wide gripper command). tests/test_torch_baxter_step.py holds the
bimanual Baxter's worlds with the same helper (hold_step).

The state: the reset's, with the cube (or the pot) pressed 1 mm into the
table so that contact rows are active from the first substep, and small
arm velocities. The actions: seeded random deltas, every binary gripper
closing (the Inspire hand's six fingers at random).

  * the injected state: the port's controller states equal the JAX
    state's leaves (1e-7), one per arm;
  * the goals: each arm's OSC goal 1e-5, the gripper command exactly;
  * each substep of the port from the JAX step's state at that substep
    against the JAX substep: qpos 1e-5, qvel 1e-4 (as
    tests/test_torch_twoarm_step.py); step_batch's next state is the
    port's own chain of its substeps, bit for bit;
  * the observations (every key, through the pipeline; hold_obs of
    tests/test_torch_door.py: 1e-5, the eef wrench at 1e-3 of its largest)
    and the reward (1e-5) of the JAX step's end state against the JAX
    package's; step_batch's are those of its own end state, exactly.

The substeps are held from the same input, not chained across the
packages: at SpotArm's initial pose (its wrist rolls aligned) the OSC law
turns the packages' 3e-7 qvel rounding difference into 8e-4 over 5
substeps, in both directions.

The JAX reference runs the step's own pieces (forward_products, the
controllers, _total_smooth_force, narrowphase, _solver_inputs_impl, the
contact solve _vel_update_xla, _integrate_qpos, the observations, the
reward), vmapped over the scenarios, all jitted but the contact solve at
nv 24-25, which runs eagerly scenario by scenario (XLA:CPU compiles its
unrolled Choleskys for minutes). For the same reason the step runs at
250 Hz control here (2 substeps; both packages' envs made with
control_freq=250): the goals, the substeps and the observations of the
20 Hz step, two of its 25 substeps.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robosuite_tpu_torch import convert
from robosuite_tpu_torch.physics import contact as C
from robosuite_tpu_torch.physics import engine
from robosuite_tpu_torch.physics.state import State
from tests.test_torch_door import hold_obs

WORLDS = {"Lift-PandaDexRH": ("Lift", "PandaDexRH"), "Lift-SpotArm": ("Lift", "SpotArm"),
          "Lift-Baxter": ("Lift", "Baxter"), "TwoArmLift-Baxter": ("TwoArmLift", "Baxter")}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pressed_state(penv, name):
    """(2, 1 + nq + nv): the port's reset with the object 1 mm into the
    table and small arm velocities."""
    s, _ = penv.reset_batch(2, torch.Generator().manual_seed(31))
    qpos, qvel = s.physics.qpos.clone(), s.physics.qvel.clone()
    m = penv.model
    if name == "Lift":
        z = m.jnt_qpos_slice("cube_joint0").start + 2
        qpos[:, z] = penv.table_top_z - float(penv.cube.bottom_offset[2]) - 0.001
    else:
        z = m.jnt_qpos_slice("pot_joint0").start + 2
        qpos[:, z] -= 0.002  # placed 1 mm above the table
    gen = torch.Generator().manual_seed(32)
    for robot in penv.robots:
        for arm in robot.arms:
            qv = torch.as_tensor(robot.arm_qvel_idx[arm])
            qvel[:, qv] = 0.1 * torch.randn(2, len(qv), generator=gen)
    return torch.cat([s.physics.time[:, None], qpos, qvel], 1).numpy()


_SETUP = {}


def setup(key, control_freq):
    """(jenv, penv, flat state, the JAX pieces, each vmapped over the
    scenarios), made once per world."""
    if (key, control_freq) in _SETUP:
        return _SETUP[key, control_freq]
    import robosuite_tpu
    import robosuite_tpu_torch
    from robosuite_tpu.ops import pallas_contact as JPC
    from robosuite_tpu.physics import contact as JC
    from robosuite_tpu.physics import engine as JE
    from robosuite_tpu.physics.state import State as JState

    name, robot = WORLDS[key]
    kw = dict(robots=robot, reward_shaping=True, control_freq=control_freq,
              **({"seed": 0} if name == "Lift" else {}))
    jenv, penv = robosuite_tpu.make(name, **kw), robosuite_tpu_torch.make(name, device="cpu", **kw)
    assert jenv.n_substeps == penv.n_substeps == round(500 / control_freq)
    jm = jenv.model
    nrows = sum(len(r) for r in JC.contact_row_layout(jm).values())
    K = min(JC.ROW_CAP, nrows) if JC.uses_row_compaction(jm) else nrows

    def before_solve(phys, packed):
        """The substep up to the contact solve: the controllers' ctrl, the
        smooth forces, the narrowphase, the solver's operands."""
        kin, M, bias = JE.forward_products(jm, phys)
        ctrl = jnp.zeros(jm.nu, dtype=phys.qpos.dtype)
        for r, c in zip(jenv.robots, jenv._unpack_ctrl(packed)):
            ctrl = r.run_controllers(kin, M, bias, phys.qpos, phys.qvel, c, ctrl)
        qfrc, extra = JE._total_smooth_force(jm, phys, ctrl, kin, bias, M)
        con = JC.narrowphase(jm, kin)
        return JC._solver_inputs_impl(jm, kin, con, M, phys.qvel, qfrc, jm.timestep, None,
                                      jm.dof_damping + extra)[0]

    pre = jax.jit(jax.vmap(before_solve))
    post = jax.jit(jax.vmap(lambda q, v: JE._integrate_qpos(jm, q, v, jm.timestep)))
    solve = lambda *a: JPC._vel_update_xla(*a, K, 0, JC.APGD_ITERS, JC.POWER_ITERS, jm.timestep)  # noqa: E731
    if jm.nv <= 16:  # XLA:CPU compiles the solve at nv 13 in seconds
        solve = jax.jit(solve)

    def substep(phys, packed):
        args = pre(phys, packed)
        with jax.disable_jit(jm.nv > 16):  # each scenario's solve unbatched
            out = [solve(*(x[b] for x in args)) for b in range(phys.qpos.shape[0])]
        qvel = jnp.stack([o[0] for o in out])
        return JState(qpos=post(phys.qpos, qvel), qvel=qvel, time=phys.time + jm.timestep), jnp.stack(
            [o[1] for o in out])

    def start(flat, action):
        """The JAX state from the flattened one (its controller reset), and
        its goals for the action."""
        state = jenv.state_from_flattened(flat)
        phys = state.physics
        kin, M, bias = JE.forward_products(jm, phys)
        cs = [r.set_goals(kin, M, bias, phys.qpos, phys.qvel, c, a) for r, c, a in
              zip(jenv.robots, jenv._unpack_ctrl(state.ctrl),
                  jenv._split_robot_actions(jnp.clip(action, *jenv._action_clip)))]
        return state, jenv._pack_ctrl(cs)

    def observe(phys, f, t):
        """The end of JAX _step_impl: the observations with the eef wrench of
        the last substep's forces, the pipeline, the reward."""
        kin = JE.forward_products(jm, phys)[0]
        obs = jenv._get_observations(phys, kin)
        for i, r in enumerate(jenv.robots):
            for arm in r.arms:
                prefix = f"robot{i}_" + ("" if arm == "right" or len(r.arms) == 1 else f"{arm}_")
                obs[f"{prefix}eef_force"], obs[f"{prefix}eef_torque"] = jenv.eef_contact_wrench(kin, f, i, arm)
        obs, _ = jenv._finalize_observations(obs, jax.random.PRNGKey(0), t)
        return obs, jenv.reward(obs, phys, kin)

    pieces = dict(start=jax.jit(jax.vmap(start)), substep=substep, observe=jax.jit(jax.vmap(observe)))
    _SETUP[key, control_freq] = jenv, penv, _pressed_state(penv, name), pieces
    return _SETUP[key, control_freq]


def _actions(penv, key):
    rng = np.random.default_rng(33)
    a = np.clip(0.5 * rng.standard_normal((2, penv.action_dim)), -1.0, 1.0).astype(np.float32)
    for robot in penv.robots:  # one robot: its action is the whole row
        idx = robot.action_split_indexes()
        for arm in robot.arms:
            s, e = idx[f"{arm}_gripper"]
            if e - s == 1:
                a[:, s] = 1.0  # closing
    return a


def _port_observe(penv, phys, f, t):
    """The end of the port's step_batch on a physics state: the end-of-step
    forward products, the observations with the eef wrench of f, the
    pipeline, the reward."""
    kin = engine.forward_products(penv.model, phys.qpos, phys.qvel)[0]
    obs = penv._wrench_obs(penv._get_observations(phys, kin), kin, f)
    return penv._finalize_observations(obs, None, t)[0], penv.reward(phys, kin)


def hold_step(key, control_freq):
    """The JAX state injected into the port, then one step_batch held
    against the JAX step (the module docstring)."""
    jenv, penv, flat, pieces = setup(key, control_freq)
    pm = penv.model
    a = torch.as_tensor(_actions(penv, key))
    js, packed = pieces["start"](jnp.asarray(flat), jnp.asarray(a.numpy()))
    ps = convert.state_from_numpy(convert.numpy_tree(js), device="cpu")
    robot, jrobot_state = penv.robots[0], jenv._unpack_ctrl(js.ctrl)[0]
    for arm in robot.arms:
        for field in ("goal_pos", "goal_ori", "kp", "kd"):
            np.testing.assert_allclose(getattr(ps.ctrl.arm[arm], field).numpy(),
                                       np.asarray(getattr(jrobot_state.arm[arm], field)), rtol=0, atol=1e-7)
        assert ps.ctrl.gripper_action[arm].shape == (2, max(len(robot.gripper_actuator_ids[arm]), 1))
    ps2, po, pr, pd, _ = penv.step_batch(ps, a)

    kin, M, bias = engine.forward_products(pm, ps.physics.qpos, ps.physics.qvel)
    ctrl = penv._set_goals(kin, M, bias, ps.physics.qpos, ps.physics.qvel, ps.ctrl, penv._clip(a))
    jc = jenv._unpack_ctrl(packed)[0]
    for arm in robot.arms:
        np.testing.assert_allclose(ctrl.arm[arm].goal_pos.numpy(), np.asarray(jc.arm[arm].goal_pos), rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(ctrl.gripper_action[arm].numpy(), np.asarray(jc.gripper_action[arm]))
        torch.testing.assert_close(ps2.ctrl.gripper_action[arm], ctrl.gripper_action[arm], rtol=0, atol=0)
    substep = penv._substep_fn(pm, ctrl, kin)
    jphys, phys = js.physics, ps.physics
    for k in range(penv.n_substeps):
        jnext, jf = pieces["substep"](jphys, packed)
        same_in = State(qpos=torch.tensor(np.asarray(jphys.qpos)), qvel=torch.tensor(np.asarray(jphys.qvel)),
                        time=torch.tensor(np.asarray(jphys.time)))
        out, f = substep(same_in, k)
        np.testing.assert_allclose(out.qpos.numpy(), np.asarray(jnext.qpos), rtol=0, atol=1e-5, err_msg=f"{k}")
        np.testing.assert_allclose(out.qvel.numpy(), np.asarray(jnext.qvel), rtol=0, atol=1e-4, err_msg=f"{k}")
        phys, f_own = substep(phys, k)
        jphys = jnext
    torch.testing.assert_close(ps2.physics.qpos, phys.qpos, rtol=0, atol=0)
    torch.testing.assert_close(ps2.physics.qvel, phys.qvel, rtol=0, atol=0)
    obs_own, r_own = _port_observe(penv, phys, f_own, ps.t)
    assert set(obs_own) == set(po)
    for k, v in po.items():
        torch.testing.assert_close(v, obs_own[k], rtol=0, atol=0, msg=k)
    torch.testing.assert_close(pr, r_own, rtol=0, atol=0)

    jo, jr = pieces["observe"](jphys, jf, js.t)
    end = State(qpos=torch.tensor(np.asarray(jphys.qpos)), qvel=torch.tensor(np.asarray(jphys.qvel)),
                time=torch.tensor(np.asarray(jphys.time)))
    obs, r = _port_observe(penv, end, f, ps.t)
    jo = {k: v for k, v in jo.items() if k != "placement_valid"}
    assert set(obs) == set(jo) == set(po)
    hold_obs(penv, obs, jo, 1e-5, key)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=0, atol=1e-5)
    if "Baxter" in key:
        assert C.uses_row_compaction(pm)
        for k in ("robot0_left_eef_force", "robot0_left_eef_torque", "robot0_eef_force"):
            assert po[k].shape == (2, 3) and not bool(po[k].any())
    else:  # the hand's and the BD gripper's meshes have no hull: no eef contact
        assert not bool(po["robot0_eef_force"].any())
    assert not bool(pd.any()) and ps2.t.tolist() == [1, 1]


@pytest.mark.parametrize("key", ["Lift-PandaDexRH", "Lift-SpotArm"])
def test_step_batch_matches_jax(key):
    """One step_batch of a fused world from the injected JAX state against
    the JAX step, at 250 Hz control (module docstring)."""
    hold_step(key, 250)
