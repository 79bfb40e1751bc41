"""The five robots that need tendons and equality constraints, in Lift, and
the wide worlds the raised kernel maxima take, in the port against the JAX
package on the CPU (each on one torch thread):

  * one policy step of Lift with UR5e (Robotiq 85: 2 spring tendons, rows
    compacted into 96 slots), Kinova3 (Robotiq 85, 122 static rows), IIWA
    (Robotiq 140: 4 tendon equalities), Jaco (three fingers: 3 tendon
    equalities, compacted) and XArm7 (a `general` servo on a tendon, 2
    connects and a joint coupling): the port's step_batch (its unfused
    plain path: the equality rows after the contact rows, ntot = 3K + ne)
    from a JAX state injected into the port (convert.numpy_tree /
    state_from_numpy), each substep from the JAX step's state at that
    substep against the JAX substep: qpos 1e-5, qvel 1e-4 (as
    tests/test_torch_robots_step.py); the goals 1e-5, the gripper command
    exactly; step_batch's next state is the port's own chain of its
    substeps, bit for bit; the observations (hold_obs: 1e-5, the eef
    wrench at 1e-3 of its largest) and the reward (1e-5) of the JAX step's
    end state (IIWA's and XArm7's, in tests/test_torch_tendon_robots_step.py,
    which takes them from here: the module's time). The step runs at 500
    Hz control (one of its substeps), the JAX contact solve eagerly,
    scenario by scenario (XLA:CPU compiles its unrolled Choleskys at nv
    18-19 for minutes);
  * PickPlaceCan and NutAssemblySingle with Baxter and PandaDexRH build in
    the port as in the JAX package (sizes, pairs, rows, qpos0 1e-7), pass
    K1's table and K2's sizes at the raised maxima (nq 48, nv 44, 32
    sites), and a model one past each maximum is refused.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robosuite_tpu_torch import convert
from robosuite_tpu_torch.ops import contact_solve, tables
from robosuite_tpu_torch.physics import contact as C
from robosuite_tpu_torch.physics import engine
from robosuite_tpu_torch.physics.state import State
from tests.test_torch_door import hold_obs

ROBOTS = ("UR5e", "Kinova3", "IIWA", "Jaco", "XArm7")
CONTROL_FREQ = 500


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pressed_state(penv):
    """(2, 1 + nq + nv): the port's reset with the cube 1 mm into the table
    and small arm velocities."""
    s, _ = penv.reset_batch(2, torch.Generator().manual_seed(31))
    qpos, qvel = s.physics.qpos.clone(), s.physics.qvel.clone()
    z = penv.model.jnt_qpos_slice("cube_joint0").start + 2
    qpos[:, z] = penv.table_top_z - float(penv.cube.bottom_offset[2]) - 0.001
    gen = torch.Generator().manual_seed(32)
    robot = penv.robots[0]
    qv = torch.as_tensor(robot.arm_qvel_idx["right"])
    qvel[:, qv] = 0.1 * torch.randn(2, len(qv), generator=gen)
    return torch.cat([s.physics.time[:, None], qpos, qvel], 1).numpy()


def setup(robot):
    """(jenv, penv, flat state, the JAX step's pieces, vmapped over the
    scenarios)."""
    import robosuite_tpu
    import robosuite_tpu_torch
    from robosuite_tpu.ops import pallas_contact as JPC
    from robosuite_tpu.physics import contact as JC
    from robosuite_tpu.physics import engine as JE
    from robosuite_tpu.physics.equality import equality_row_count, equality_rows
    from robosuite_tpu.physics.state import State as JState

    kw = dict(robots=robot, reward_shaping=True, control_freq=CONTROL_FREQ, seed=0)
    jenv, penv = robosuite_tpu.make("Lift", **kw), robosuite_tpu_torch.make("Lift", device="cpu", **kw)
    jm = jenv.model
    ne = equality_row_count(jm)
    K = (JC.contact_warmstart_dim(jm) - ne) // 3

    def before_solve(phys, packed):
        kin, M, bias = JE.forward_products(jm, phys)
        ctrl = jenv.robots[0].run_controllers(kin, M, bias, phys.qpos, phys.qvel, jenv._unpack_ctrl(packed)[0],
                                              jnp.zeros(jm.nu, dtype=phys.qpos.dtype))
        qfrc, extra = JE._total_smooth_force(jm, phys, ctrl, kin, bias, M)
        eq = equality_rows(jm, kin, phys.qpos, phys.qvel) if jm.neq else None
        return JC._solver_inputs_impl(jm, kin, JC.narrowphase(jm, kin), M, phys.qvel, qfrc, jm.timestep, eq,
                                      jm.dof_damping + extra)[0]

    pre = jax.jit(jax.vmap(before_solve))
    post = jax.jit(jax.vmap(lambda q, v: JE._integrate_qpos(jm, q, v, jm.timestep)))

    def substep(phys, packed):
        args = pre(phys, packed)
        with jax.disable_jit():  # each scenario's solve unbatched
            out = [JPC._vel_update_xla(*(x[b] for x in args), K, ne, JC.APGD_ITERS, JC.POWER_ITERS, jm.timestep)
                   for b in range(phys.qpos.shape[0])]
        qvel = jnp.stack([o[0] for o in out])
        return JState(qpos=post(phys.qpos, qvel), qvel=qvel, time=phys.time + jm.timestep), jnp.stack(
            [o[1] for o in out])

    def start(flat, action):
        state = jenv.state_from_flattened(flat)
        phys = state.physics
        kin, M, bias = JE.forward_products(jm, phys)
        cs = [r.set_goals(kin, M, bias, phys.qpos, phys.qvel, c, a) for r, c, a in
              zip(jenv.robots, jenv._unpack_ctrl(state.ctrl),
                  jenv._split_robot_actions(jnp.clip(action, *jenv._action_clip)))]
        return state, jenv._pack_ctrl(cs)

    def observe(phys, f, t):
        kin = JE.forward_products(jm, phys)[0]
        obs = jenv._get_observations(phys, kin)
        obs["robot0_eef_force"], obs["robot0_eef_torque"] = jenv.eef_contact_wrench(kin, f, 0, "right")
        obs, _ = jenv._finalize_observations(obs, jax.random.PRNGKey(0), t)
        return obs, jenv.reward(obs, phys, kin)

    pieces = dict(start=jax.jit(jax.vmap(start)), substep=substep, observe=jax.jit(jax.vmap(observe)))
    return jenv, penv, _pressed_state(penv), pieces


def _port_observe(penv, phys, f, t):
    kin = engine.forward_products(penv.model, phys.qpos, phys.qvel)[0]
    obs = penv._wrench_obs(penv._get_observations(phys, kin), kin, f)
    return penv._finalize_observations(obs, None, t)[0], penv.reward(phys, kin)


def hold_step(robot, observations):
    """One step_batch from the injected JAX state held against the JAX
    step (the module docstring); the observations too where asked."""
    jenv, penv, flat, pieces = setup(robot)
    pm = penv.model
    assert penv._fused_for(pm) is None and penv.n_substeps == 1
    rng = np.random.default_rng(33)
    a = np.clip(0.5 * rng.standard_normal((2, penv.action_dim)), -1.0, 1.0).astype(np.float32)
    a[:, -1] = 1.0  # closing
    a = torch.as_tensor(a)
    js, packed = pieces["start"](jnp.asarray(flat), jnp.asarray(a.numpy()))
    ps = convert.state_from_numpy(convert.numpy_tree(js), device="cpu")
    jrs = jenv._unpack_ctrl(js.ctrl)[0]
    for field in ("goal_pos", "goal_ori", "kp", "kd"):
        np.testing.assert_allclose(getattr(ps.ctrl.arm["right"], field).numpy(),
                                   np.asarray(getattr(jrs.arm["right"], field)), rtol=0, atol=1e-7)
    ps2, po, pr, pd, _ = penv.step_batch(ps, a)

    kin, M, bias = engine.forward_products(pm, ps.physics.qpos, ps.physics.qvel)
    ctrl = penv._set_goals(kin, M, bias, ps.physics.qpos, ps.physics.qvel, ps.ctrl, penv._clip(a))
    jc = jenv._unpack_ctrl(packed)[0]
    np.testing.assert_allclose(ctrl.arm["right"].goal_pos.numpy(), np.asarray(jc.arm["right"].goal_pos), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(ctrl.gripper_action["right"].numpy(), np.asarray(jc.gripper_action["right"]))
    substep = penv._substep_fn(pm, ctrl, kin)
    jphys, phys = js.physics, ps.physics
    for k in range(penv.n_substeps):
        jnext, jf = pieces["substep"](jphys, packed)
        same_in = State(qpos=torch.tensor(np.asarray(jphys.qpos)), qvel=torch.tensor(np.asarray(jphys.qvel)),
                        time=torch.tensor(np.asarray(jphys.time)))
        out, f = substep(same_in, k)
        assert f.shape[1] == C.contact_warmstart_dim(pm) == jf.shape[1]
        np.testing.assert_allclose(out.qpos.numpy(), np.asarray(jnext.qpos), rtol=0, atol=1e-5, err_msg=f"{k}")
        np.testing.assert_allclose(out.qvel.numpy(), np.asarray(jnext.qvel), rtol=1e-5, atol=1e-4, err_msg=f"{k}")
        phys, f_own = substep(phys, k)
        jphys = jnext
    torch.testing.assert_close(ps2.physics.qpos, phys.qpos, rtol=0, atol=0)
    torch.testing.assert_close(ps2.physics.qvel, phys.qvel, rtol=0, atol=0)
    obs_own, r_own = _port_observe(penv, phys, f_own, ps.t)
    for k, v in po.items():
        torch.testing.assert_close(v, obs_own[k], rtol=0, atol=0, msg=k)
    torch.testing.assert_close(pr, r_own, rtol=0, atol=0)
    assert not bool(pd.any()) and ps2.t.tolist() == [1, 1]
    if not observations:
        return
    jo, jr = pieces["observe"](jphys, jf, js.t)
    end = State(qpos=torch.tensor(np.asarray(jphys.qpos)), qvel=torch.tensor(np.asarray(jphys.qvel)),
                time=torch.tensor(np.asarray(jphys.time)))
    obs, r = _port_observe(penv, end, f, ps.t)
    jo = {k: v for k, v in jo.items() if k != "placement_valid"}
    assert set(obs) == set(jo) == set(po)
    hold_obs(penv, obs, jo, 1e-5, robot)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=0, atol=1e-5)


@pytest.mark.parametrize("robot", ["UR5e", "Kinova3", "Jaco"])
def test_step_batch_matches_jax(robot):
    """The physics of one step (IIWA's and XArm7's, with the observations:
    tests/test_torch_tendon_robots_step.py)."""
    hold_step(robot, observations=False)


WIDE = {"PickPlaceCan-Baxter": ("PickPlaceCan", "Baxter", (46, 42, 19)),
        "PickPlaceCan-PandaDexRH": ("PickPlaceCan", "PandaDexRH", (47, 43, 22)),
        "NutAssemblySingle-Baxter": ("NutAssemblySingle", "Baxter", (32, 30, 28)),
        "NutAssemblySingle-PandaDexRH": ("NutAssemblySingle", "PandaDexRH", (33, 31, 31))}


@pytest.mark.parametrize("key", list(WIDE))
def test_wide_world_builds_as_jax_and_fits_the_raised_maxima(key):
    import robosuite_tpu
    import robosuite_tpu_torch

    name, robot, sizes = WIDE[key]
    jm = robosuite_tpu.make(name, robots=robot).model
    pm = robosuite_tpu_torch.make(name, robots=robot, device="cpu").model
    for f in ("nq", "nv", "nbody", "njnt", "ngeom", "nsite", "nu", "npair", "ntendon", "neq"):
        assert getattr(pm, f) == getattr(jm, f), f
    assert (pm.nq, pm.nv, pm.nsite) == sizes
    assert C.contact_warmstart_dim(pm) == 3 * C.ROW_CAP and C.uses_row_compaction(pm)
    np.testing.assert_allclose(pm.qpos0.numpy(), np.asarray(jm.qpos0), rtol=0, atol=1e-7)
    np.testing.assert_allclose(pm.body_mass.numpy(), np.asarray(jm.body_mass), rtol=0, atol=1e-7)
    assert tables.check_model(pm, contacts=False) == 0
    tables.pack(pm)
    contact_solve.check_sizes(pm.nv, C.ROW_CAP)
    for field, cap in (("nq", tables.MAXQ), ("nv", tables.MAXV), ("nsite", tables.MAXS)):
        big = copy.copy(pm)
        setattr(big, field, cap + 1)
        with pytest.raises(ValueError, match=f"{field}={cap + 1} exceeds the kernels' maximum {cap}"):
            tables.check_model(big, contacts=False)
    with pytest.raises(ValueError, match=f"nv={tables.MAXV + 1}"):
        contact_solve.check_sizes(tables.MAXV + 1, C.ROW_CAP)
    with pytest.raises(ValueError, match=f"ne={tables.MAXE + 1}"):
        contact_solve.check_sizes(pm.nv, C.ROW_CAP, tables.MAXE + 1)
