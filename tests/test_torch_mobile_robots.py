"""The wheeled robots, PandaOmron (HYBRID_MOBILE_BASE on an Omron base)
and Tiago (bimanual, torso and head, a NullMobileBase), in Lift, in the
port against the JAX package on the CPU (each on one torch thread):

  * the worlds build as the JAX package's (every compiled leaf at 1e-6,
    every static field equal), with the MobileRobot runtime and the action
    layout of the JAX tests' REF_SPLITS (tests/test_mobile_robots.py:23-45),
    and fit K1's raised maxima (Tiago: 60 bodies, 31 joints; RS_MAXB 64,
    RS_MAXJ 32) and K2's sizes; the fused gate refuses them
    ("non-fixed-base robot"; Tiago's gripper tendons first), so they run
    unfused on the card;
  * the composite spec's split against the JAX spec's, and the runtime
    robot's layout taken from it;
  * a 6-joint fixed arm (UR5e) under the "JOINT_POSITION" name runs in
    the port, its config sized by its joints, where the JAX step raises;
  * the mobile-base part controller's set_goal and run against the JAX
    functions at 1e-6;
  * _initial_qpos sets the torso's init posture (PandaOmron's 0.2);
  * state_from_numpy carries a JAX state holding the parts'
    JointPosState and MobileBaseState;
  * one step_batch policy step of Lift-PandaOmron (Lift-Tiago's:
    tests/test_torch_mobile_robots_step.py) from a JAX state injected into
    the port (hold_step, which the legged and whole-body IK tests share):
    the goals of every part at 1e-5 and the grippers'
    commands exactly; each substep, from the JAX step's state at that
    substep, against the JAX substep at qpos 1e-5 and qvel 1e-4 (as
    tests/test_torch_robots_step.py); step_batch's next state the port's
    own chain of its substeps, bit for bit; with `observations`, the
    observations (hold_obs: 1e-5, the eef wrench at 1e-3 of its largest)
    and the reward (1e-5) of the JAX step's end state. The step runs at
    500 Hz control (one substep), the JAX contact solve eagerly, scenario
    by scenario (XLA:CPU compiles its unrolled Choleskys at nv 19-36 for
    minutes).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robosuite_tpu_torch import convert
from robosuite_tpu_torch.ops import contact_solve, substep as psub, tables
from robosuite_tpu_torch.physics import contact as C
from robosuite_tpu_torch.physics import engine
from robosuite_tpu_torch.physics.state import State
from tests.test_torch_door import hold_obs

CONTROL_FREQ = 500

# the JAX package's tests/test_mobile_robots.py REF_SPLITS (read off
# robosuite's composite split)
REF_SPLITS = {
    "PandaOmron": {"right": (0, 6), "torso": (6, 7), "base": (7, 10), "right_gripper": (10, 11),
                   "base_mode": (11, 12)},
    "Tiago": {"right": (0, 6), "left": (6, 12), "torso": (12, 13), "head": (13, 15), "base": (15, 18),
              "right_gripper": (18, 19), "left_gripper": (19, 20)},
    "SpotWithArmFloating": {"right": (0, 6), "base": (6, 9), "right_gripper": (9, 10)},
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pressed_state(penv):
    """(2, 1 + nq + nv): the port's reset with the cube 1 mm into the table
    and small velocities on every arm joint."""
    s, _ = penv.reset_batch(2, torch.Generator().manual_seed(31))
    qpos, qvel = s.physics.qpos.clone(), s.physics.qvel.clone()
    z = penv.model.jnt_qpos_slice("cube_joint0").start + 2
    qpos[:, z] = penv.table_top_z - float(penv.cube.bottom_offset[2]) - 0.001
    gen = torch.Generator().manual_seed(32)
    robot = penv.robots[0]
    for arm in robot.arms:
        qv = torch.as_tensor(robot.arm_qvel_idx[arm])
        qvel[:, qv] = 0.1 * torch.randn(2, len(qv), generator=gen)
    return torch.cat([s.physics.time[:, None], qpos, qvel], 1).numpy()


def jax_arm_dims(jenv):
    """Tiago under its whole-body IK config: the JAX robot's JOINT_POSITION
    arm trackers resized to the arm's 6 joints. The JAX factory builds a
    composite JSON's JOINT_POSITION arms 7 wide (arm_controller_config's
    default dim), which a 6-joint arm cannot run (its gains (7,) against a
    (6,) error); the port sizes them by the arm. Every other robot's JAX
    configs already fit its arms, and there this asserts that it changes
    nothing."""
    r = jenv.robots[0]
    sized = {arm: dataclasses.replace(c, dim=len(r.arm_qpos_idx[arm])) if hasattr(c, "dim") else c
             for arm, c in r.arm_cfg.items()}
    if type(r.rm).__name__ == "Tiago" and r._wbik_spec is not None:
        r.arm_cfg = sized
    else:
        assert sized == r.arm_cfg, "the JAX robot's arm configs do not fit its arms"


def setup(robot, controller_configs=None):
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
    jenv = robosuite_tpu.make("Lift", controller_configs=controller_configs, **kw)
    penv = robosuite_tpu_torch.make("Lift", device="cpu", controller_configs=controller_configs and (
        controller_configs.replace("robosuite_tpu/", "robosuite_tpu_torch/")), **kw)
    jax_arm_dims(jenv)
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
        for arm in jenv.robots[0].arms:
            p = "robot0_" + ("" if arm == "right" else f"{arm}_")
            obs[f"{p}eef_force"], obs[f"{p}eef_torque"] = jenv.eef_contact_wrench(kin, f, 0, arm)
        obs, _ = jenv._finalize_observations(obs, jax.random.PRNGKey(0), t)
        return obs, jenv.reward(obs, phys, kin)

    pieces = dict(start=jax.jit(jax.vmap(start)), substep=substep, observe=jax.jit(jax.vmap(observe)), pre=pre)
    return jenv, penv, pressed_state(penv), pieces


def port_observe(penv, phys, f, t):
    kin = engine.forward_products(penv.model, phys.qpos, phys.qvel)[0]
    obs = penv._wrench_obs(penv._get_observations(phys, kin), kin, f)
    return penv._finalize_observations(obs, None, t)[0], penv.reward(phys, kin)


def hold_ctrl(pc, jc, atol):
    """Every part's controller state (goals and gains) of the port against
    the JAX one at atol, the grippers' commands exactly."""
    assert set(pc.arm) == set(jc.arm)
    for part, st in pc.arm.items():
        for f in dataclasses.fields(st):
            got, want = getattr(st, f.name), getattr(jc.arm[part], f.name)
            if got is None:
                assert want is None, (part, f.name)
                continue
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol, err_msg=f"{part}.{f.name}")
    for arm, g in pc.gripper_action.items():
        np.testing.assert_array_equal(g.numpy(), np.asarray(jc.gripper_action[arm]))


def hold_substep_on_tie(penv, pieces, jphys, packed, same_in, jnext, b, worst_dof):
    """Scenario b of a substep whose port output parts from the JAX one,
    most in dof worst_dof: passes only where a float64 witness shows a
    contact decision float32 rounding takes either way in that dof's
    body's contact island (chip_smoke.contact_tie_witness: a box-box SAT
    or manifold-cut near-tie: GR1's head-roll box deep in its chest box),
    and the port's solve and integration on the JAX step's own solver
    operands give the JAX substep's output (qpos 1e-5, qvel 1e-4): the two
    differ only in which of the tied contact points fill the compacted
    slots. -> the witness."""
    import chip_smoke

    pm = penv.model
    wit = chip_smoke.contact_tie_witness(pm, same_in.qpos[b:b + 1], [int(pm.dof_bodyid[worst_dof])])[0]
    assert wit is not None, f"scenario {b}: dof {worst_dof} parts from the JAX substep with no float64 tie witness"
    args = [torch.tensor(np.asarray(x)[b:b + 1]) for x in pieces["pre"](jphys, packed)]
    qvel, _ = contact_solve.vel_update_plain(*args, *C.solver_iterations(pm), pm.timestep)
    qpos = engine.integrate_qpos(pm, same_in.qpos[b:b + 1], qvel, pm.timestep)
    np.testing.assert_allclose(qpos.numpy(), np.asarray(jnext.qpos)[b:b + 1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(qvel.numpy(), np.asarray(jnext.qvel)[b:b + 1], rtol=1e-5, atol=1e-4)
    return wit


def hold_step(robot, controller_configs=None, observations=False, action=None, goal_tol=1e-5, ties=False):
    """One step_batch from the injected JAX state held against the JAX
    step (the module docstring); the observations too where asked.
    action: a (2, A) numpy action (default: seeded, clipped normal). With
    `ties`, a scenario whose substep parts from the JAX one is held by
    hold_substep_on_tie instead. -> the witnesses of those scenarios."""
    jenv, penv, flat, pieces = setup(robot, controller_configs)
    pm = penv.model
    assert penv._fused_for(pm) is None and penv.n_substeps == 1
    if action is None:
        rng = np.random.default_rng(33)
        action = np.clip(0.5 * rng.standard_normal((2, penv.action_dim)), -1.0, 1.0).astype(np.float32)
    a = torch.as_tensor(action)
    js, packed = pieces["start"](jnp.asarray(flat), jnp.asarray(action))
    ps = convert.state_from_numpy(convert.numpy_tree(js), device="cpu")
    hold_ctrl(ps.ctrl, jenv._unpack_ctrl(js.ctrl)[0], 0.0)
    ps2, po, pr, pd, _ = penv.step_batch(ps, a)

    kin, M, bias = engine.forward_products(pm, ps.physics.qpos, ps.physics.qvel)
    ctrl = penv._set_goals(kin, M, bias, ps.physics.qpos, ps.physics.qvel, ps.ctrl, penv._clip(a))
    hold_ctrl(ctrl, jenv._unpack_ctrl(packed)[0], goal_tol)
    substep = penv._substep_fn(pm, ctrl, kin)
    jphys, phys = js.physics, ps.physics
    witnesses = []
    for k in range(penv.n_substeps):
        jnext, jf = pieces["substep"](jphys, packed)
        same_in = State(qpos=torch.tensor(np.asarray(jphys.qpos)), qvel=torch.tensor(np.asarray(jphys.qvel)),
                        time=torch.tensor(np.asarray(jphys.time)))
        out, f = substep(same_in, k)
        assert f.shape[1] == C.contact_warmstart_dim(pm) == jf.shape[1]
        if ties:
            jq, jv = np.asarray(jnext.qpos), np.asarray(jnext.qvel)
            dv = np.abs(out.qvel.numpy() - jv)
            far = (np.abs(out.qpos.numpy() - jq) > 1e-5).any(axis=1) | (dv > 1e-4 + 1e-5 * np.abs(jv)).any(axis=1)
            for b in np.nonzero(far)[0]:
                witnesses.append(hold_substep_on_tie(penv, pieces, jphys, packed, same_in, jnext, int(b),
                                                     int(dv[b].argmax())))
        else:
            np.testing.assert_allclose(out.qpos.numpy(), np.asarray(jnext.qpos), rtol=0, atol=1e-5, err_msg=f"{k}")
            np.testing.assert_allclose(out.qvel.numpy(), np.asarray(jnext.qvel), rtol=1e-5, atol=1e-4,
                                       err_msg=f"{k}")
        phys, f_own = substep(phys, k)
        jphys = jnext
    torch.testing.assert_close(ps2.physics.qpos, phys.qpos, rtol=0, atol=0)
    torch.testing.assert_close(ps2.physics.qvel, phys.qvel, rtol=0, atol=0)
    obs_own, r_own = port_observe(penv, phys, f_own, ps.t)
    for k, v in po.items():
        torch.testing.assert_close(v, obs_own[k], rtol=0, atol=0, msg=k)
    torch.testing.assert_close(pr, r_own, rtol=0, atol=0)
    assert not bool(pd.any()) and ps2.t.tolist() == [1, 1]
    if not observations:
        return witnesses
    jo, jr = pieces["observe"](jphys, jf, js.t)
    end = State(qpos=torch.tensor(np.asarray(jphys.qpos)), qvel=torch.tensor(np.asarray(jphys.qvel)),
                time=torch.tensor(np.asarray(jphys.time)))
    obs, r = port_observe(penv, end, f, ps.t)
    jo = {k: v for k, v in jo.items() if k != "placement_valid"}
    assert set(obs) == set(jo) == set(po)
    hold_obs(penv, obs, jo, 1e-5, robot)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=0, atol=1e-5)
    return witnesses


def build_both(robot, **kw):
    import robosuite_tpu
    import robosuite_tpu_torch

    return (robosuite_tpu.make("Lift", robots=robot, seed=0, **kw),
            robosuite_tpu_torch.make("Lift", robots=robot, seed=0, device="cpu", **kw))


def hold_world(jenv, penv):
    """The compiled models equal (leaves at 1e-6, static fields exactly)
    and the runtime's class, splits and part indices the JAX one's."""
    from robosuite_tpu_torch.models.model import LEAVES, STATIC

    jm, pm = jenv.model, penv.model
    for name in LEAVES:
        np.testing.assert_allclose(getattr(pm, name).numpy(), np.asarray(getattr(jm, name)), rtol=0, atol=1e-6,
                                   err_msg=name)
    for name in STATIC:
        want = getattr(jm, name)
        got = getattr(pm, name)
        assert (tuple(got) if isinstance(got, (list, tuple)) else got) == (
            tuple(want) if isinstance(want, (list, tuple)) else want), name
    jr, pr = jenv.robots[0], penv.robots[0]
    assert type(pr).__name__ == type(jr).__name__
    assert pr.action_split_indexes() == jr.action_split_indexes() and penv.action_dim == jenv.action_dim
    for part in ("torso", "head", "base", "legs"):
        for field in ("part_qpos_idx", "part_qvel_idx", "part_actuator_ids"):
            np.testing.assert_array_equal(getattr(pr, field)[part], getattr(jr, field)[part])
    for lo_hi in zip(penv.action_spec, jenv.action_spec):
        np.testing.assert_array_equal(*lo_hi)


@pytest.mark.parametrize("robot", ["PandaOmron", "Tiago"])
def test_world_builds_as_jax_and_fits_the_kernels(robot):
    jenv, penv = build_both(robot)
    hold_world(jenv, penv)
    assert penv.robots[0].action_split_indexes() == REF_SPLITS[robot]
    pm = penv.model
    assert tables.check_model(pm, contacts=False) == 0
    tables.pack(pm)
    contact_solve.check_sizes(pm.nv, (C.contact_warmstart_dim(pm) - 0) // 3)
    # Tiago's Robotiq 85s carry tendons, refused first, as the JAX gate does
    with pytest.raises(psub.UnsupportedFused, match="tendons" if robot == "Tiago" else "non-fixed-base robot"):
        psub.extract_spec(penv, pm)
    assert penv._fused_for(pm) is None
    if robot == "Tiago":
        # the first world past K1's earlier maxima (56 bodies, 24 joints)
        assert (pm.nbody, pm.njnt, pm.nq, pm.nv, int(pm.ancestor_mask.count_nonzero())) == (60, 31, 37, 36, 373)
        assert C.uses_row_compaction(pm) and C.contact_warmstart_dim(pm) == 3 * C.ROW_CAP


@pytest.mark.parametrize("name", ["OmronMobileBase", "NullMobileBase", "FloatingLeggedBase", "NoActuationBase",
                                  "Spot", "SpotFloating"])
def test_base_matches_jax(name):
    """Each mobile and legged base's metadata (its joints by part, centre
    site, posture, offsets) and actuators as the JAX package's."""
    from robosuite_tpu.models.bases import robot_base_factory as jfactory
    from robosuite_tpu_torch.models.bases import robot_base_factory

    jb, pb = jfactory(name, idn=0), robot_base_factory(name, idn=0)
    assert not pb.mount and pb.naming_prefix == jb.naming_prefix
    for attr in ("base_joints", "torso_joints", "leg_joints", "center_site"):
        assert getattr(pb, attr) == getattr(jb, attr), attr
    for attr in ("init_qpos", "top_offset", "bottom_offset"):
        np.testing.assert_array_equal(getattr(pb, attr), getattr(jb, attr), err_msg=attr)
    assert pb.horizontal_radius == jb.horizontal_radius and getattr(pb, "leg_servo", None) == getattr(
        jb, "leg_servo", None)
    def act(a):
        return (a.name, a.joint, a.kind, float(a.gear), tuple(np.ravel(a.ctrlrange)), tuple(np.ravel(a.forcerange)),
                a.kp, a.kv)

    assert [act(a) for a in pb.actuators()] == [act(a) for a in jb.actuators()]


def test_composite_spec_split_is_the_robots():
    """CompositeControllerSpec.action_split (arms, the mobile parts,
    grippers, HYBRID's base_mode) as the JAX spec's, and as the
    PandaOmron runtime's action_split_indexes."""
    from robosuite_tpu.controllers.composite import make_composite as jmake
    from robosuite_tpu_torch.controllers.composite import make_composite

    kw = dict(arms=("right",), gripper_dims={"right": 1}, part_dims={"torso": 1, "base": 3})
    for ctype in ("BASIC", "HYBRID_MOBILE_BASE", "WHOLE_BODY_IK"):
        spec, jspec = make_composite(ctype, **kw), jmake(ctype, **kw)
        assert spec.action_split == jspec.action_split and spec.action_dim == jspec.action_dim, ctype
    split, i = {}, 0
    for name, _, w in make_composite("HYBRID_MOBILE_BASE", **kw).action_split:
        split[name], i = (i, i + w), i + w
    assert split == REF_SPLITS["PandaOmron"]
    with pytest.raises(ValueError, match="unknown composite"):
        make_composite("NO_SUCH")
    # the runtime robot's layout is its spec's split
    import robosuite_tpu_torch

    robot = robosuite_tpu_torch.make("Lift", robots="PandaOmron", device="cpu").robots[0]
    assert robot.composite_spec.action_split == make_composite("HYBRID_MOBILE_BASE", **kw).action_split
    assert robot.action_split_indexes() == robot.composite_spec.split_indexes() == REF_SPLITS["PandaOmron"]


def test_joint_space_name_fits_a_six_joint_fixed_arm():
    """A 6-joint fixed arm (UR5e) under the "JOINT_POSITION" name: the port
    sizes the arm's config by its joints (action 6 + 1 wide) and steps; the
    JAX factory leaves the config 7 wide and the JAX step raises (ROADMAP
    Queue 3)."""
    import robosuite_tpu
    import robosuite_tpu_torch

    penv = robosuite_tpu_torch.make("Lift", robots="UR5e", controller_configs="JOINT_POSITION", device="cpu")
    robot = penv.robots[0]
    assert robot.arm_cfg["right"].dim == len(robot.arm_qpos_idx["right"]) == 6 and penv.action_dim == 7
    s, _ = penv.reset_batch(2, torch.Generator().manual_seed(3))
    a = torch.zeros(2, 7)
    a[:, :6] = 0.5
    s2, _, r, _, _ = penv.step_batch(s, a)
    q0 = s.physics.qpos[:, torch.as_tensor(robot.arm_qpos_idx["right"])]
    # delta input: the goal moves each joint by 0.5 of its 0.05 rad output range
    torch.testing.assert_close(s2.ctrl.arm["right"].goal_qpos, q0 + 0.025, rtol=0, atol=1e-6)
    assert torch.isfinite(s2.physics.qpos).all() and torch.isfinite(r).all()

    jenv = robosuite_tpu.make("Lift", robots="UR5e", controller_configs="JOINT_POSITION")
    assert jenv.robots[0].arm_cfg["right"].dim == 7 and jenv.action_dim == 8
    js, _ = jenv.reset(jax.random.PRNGKey(0))
    with pytest.raises(TypeError, match="incompatible shapes"):
        jenv.step(js, jnp.zeros(jenv.action_dim))


def test_mobile_base_controller_matches_jax():
    from robosuite_tpu.controllers.parts import mobile_base as jmb
    from robosuite_tpu_torch.controllers.parts import mobile_base as pmb

    rng = np.random.default_rng(5)
    B = 6
    act = rng.uniform(-1.5, 1.5, (B, 3)).astype(np.float32)
    yaw0, yaw = rng.uniform(-3, 3, B).astype(np.float32), rng.uniform(-3, 3, B).astype(np.float32)
    lo, hi = np.array([-1.0, -1.0, -1.5], np.float32), np.array([1.0, 1.0, 1.5], np.float32)
    jcfg, pcfg = jmb.MobileBaseJointVelConfig(), pmb.MobileBaseJointVelConfig()
    st = pmb.set_goal(pcfg, pmb.init_state(pcfg, torch.tensor(yaw0)), torch.tensor(act), torch.tensor(yaw))
    ctrl = pmb.run(pcfg, st, torch.tensor(lo), torch.tensor(hi))
    for b in range(B):
        js = jmb.set_goal(jcfg, jmb.init_state(jcfg, yaw0[b]), jnp.asarray(act[b]), yaw[b])
        np.testing.assert_allclose(st.goal_qvel[b].numpy(), np.asarray(js.goal_qvel), rtol=0, atol=1e-6)
        np.testing.assert_allclose(ctrl[b].numpy(), np.asarray(jmb.run(jcfg, js, jnp.asarray(lo), jnp.asarray(hi))),
                                   rtol=0, atol=1e-6)
    assert pcfg.control_dim == 3 and st.init_yaw is not None


def test_initial_qpos_sets_the_torso_posture():
    """PandaOmron's torso lift starts at init_torso_qpos (0.2), with no
    noise, over the card's init_qpos; the base's planar joints at 0."""
    import robosuite_tpu_torch

    env = robosuite_tpu_torch.make("Lift", robots="PandaOmron", device="cpu", seed=0)
    r = env.robots[0]
    q = env._initial_qpos(3, torch.Generator().manual_seed(0))
    assert torch.equal(q[:, r.part_qpos_idx["torso"]], torch.full((3, 1), 0.2))
    assert torch.equal(q[:, r.part_qpos_idx["base"]], torch.zeros(3, 3))
    iq = torch.as_tensor(np.asarray(r.rm.init_qpos, dtype=np.float32))
    assert (q[:, r.arm_qpos_idx["right"]] - iq).abs().max() < 0.2  # init_qpos + 0.02 noise


def test_state_from_numpy_round_trips_the_parts():
    """A JAX controller state of Tiago's layout (two arms' OSCState, torso
    and head JointPosState, the base's MobileBaseState) comes across leaf
    for leaf, each part as the port's own reset builds it (the steps below
    carry whole JAX states across too)."""
    import robosuite_tpu_torch
    from robosuite_tpu.controllers.parts import joint_pos as jjp
    from robosuite_tpu.controllers.parts import mobile_base as jmb
    from robosuite_tpu.controllers.parts import osc as josc
    from robosuite_tpu.robots.robot import RobotCtrlState as JCtrl

    rng = np.random.default_rng(6)

    def r(*shape):
        return jnp.asarray(rng.standard_normal((2,) + shape).astype(np.float32))

    arm = {a: josc.OSCState(goal_pos=r(3), goal_ori=r(3, 3), kp=r(6), kd=r(6)) for a in ("right", "left")}
    arm.update(torso=jjp.JointPosState(goal_qpos=r(1), kp=r(1), kd=r(1)),
               head=jjp.JointPosState(goal_qpos=r(2), kp=r(2), kd=r(2)),
               base=jmb.MobileBaseState(goal_qvel=r(3), init_yaw=r()))
    jc = JCtrl(arm=arm, gripper_action={"right": r(1), "left": r(1)})
    tree = dict(physics=dict(qpos=np.zeros((2, 37), np.float32), qvel=np.zeros((2, 36), np.float32), time=None),
                ctrl=convert.numpy_tree(jc), t=None)
    ps = convert.state_from_numpy(tree, device="cpu")
    hold_ctrl(ps.ctrl, jc, 0.0)
    own, _ = robosuite_tpu_torch.make("Lift", robots="Tiago", device="cpu", seed=0).reset_batch(
        2, torch.Generator().manual_seed(0))
    assert {k: type(v) for k, v in own.ctrl.arm.items()} == {k: type(v) for k, v in ps.ctrl.arm.items()}
    assert own.ctrl.arm["base"].init_yaw.shape == (2,) and own.ctrl.arm["head"].goal_qpos.shape == (2, 2)


def test_pandaomron_step_matches_jax():
    """Base mode on in one scenario, off in the other (HYBRID's OSC goal
    from the previous goal or from the achieved pose)."""
    rng = np.random.default_rng(34)
    a = np.clip(0.5 * rng.standard_normal((2, 12)), -1.0, 1.0).astype(np.float32)
    a[:, -1] = (1.0, -1.0)
    hold_step("PandaOmron", observations=True, action=a)
