"""The Door-Panda slice (OSC_POSE): the port on the CPU (its plain path)
against the JAX package on the same inputs.

  * the world and the fused substep's arm spec, with and without the
    latch, from one seed: the same sizes, door pose, pair list and joints;
  * the narrowphase on Door states: every candidate of each of its five
    pair types against the JAX lane formulas, and the whole contact buffer
    against the JAX narrowphase (1e-5); plane-cylinder and
    cylinder-cylinder pairs that touch, on small spec worlds (a tilted and
    an upright cylinder on a plane, crossed and parallel cylinders);
  * one fused substep (ops/substep.substep_plain) against the JAX
    make_fused_substep, from states with the gripper on the handle, the
    hinge past its limits and the latch near its stops: qpos 1e-5, qvel
    1e-4, as tests/test_torch_stack.py holds Stack's;
  * step_batch over 5 policy steps from the same injected state (gripper
    on the handle, horizon 3): the first step's qpos, qvel, reward and
    observations 1e-4, then every step's observations and rewards 1e-3 (as
    the three-step arm qpos of test_torch_stack.py), done exactly, and the
    eef force and torque of the finger pads' contact within 1e-3 of the
    largest;
  * door_residual against the JAX one: 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robosuite_tpu_torch import convert
from robosuite_tpu_torch.models import model as PM
from robosuite_tpu_torch.models import spec as S
from robosuite_tpu_torch.ops import forward, substep
from robosuite_tpu_torch.physics import contact as C
from robosuite_tpu_torch.physics import engine, kinematics
from robosuite_tpu_torch.physics.state import KinData

KW = dict(robots="Panda", reward_shaping=True, seed=0)
KIN_FIELDS = ("xpos", "xquat", "xmat", "xipos", "ximat", "sdof_ang", "sdof_lin",
              "geom_xpos", "geom_xmat", "site_xpos", "site_xmat")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain path on batches of 2 to 4: torch's intra-op threads would
    only spin beside the other test workers, so this module runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def envs():
    import robosuite_tpu
    import robosuite_tpu_torch

    return robosuite_tpu.make("Door", horizon=3, **KW), robosuite_tpu_torch.make("Door", device="cpu", horizon=3, **KW)


@pytest.fixture(scope="module")
def contact(envs):
    """(2, 1 + nq + nv) flattened states of the port's Door (plain path):
    the gripper driven by OSC deltas over the handle, down onto it and
    closing on it (ab_kernels.door_drive, the drive of chip_smoke.py's
    Door contact state)."""
    from robosuite_tpu_torch import ab_kernels

    _, penv = envs
    s, _ = penv.reset_batch(2, torch.Generator().manual_seed(0))
    s = ab_kernels.door_drive(penv, s)
    return torch.cat([s.physics.time[:, None], s.physics.qpos, s.physics.qvel], dim=1).numpy()


def _limits(env, flat):
    """The contact states with the hinge past its upper limit (scenario 0)
    and below its lower one (scenario 1), the latch near +1.57 and -1.57."""
    out = flat.copy()
    h, l = 1 + env.hinge_qpos_addr, 1 + env.handle_qpos_addr
    out[:, h] = [0.42, -0.02]
    out[:, l] = [1.56, -1.56]
    return out


@pytest.mark.parametrize("use_latch", [True, False], ids=["latch", "no_latch"])
def test_world_and_spec_match_jax(use_latch):
    """One seed, one world: sizes, the door's pose (drawn at construction),
    the pair list and row count, the door's joints, the fused spec."""
    import robosuite_tpu
    import robosuite_tpu_torch
    from robosuite_tpu.ops.pallas_substep import extract_spec as jextract
    from robosuite_tpu.physics import contact as JC

    jenv = robosuite_tpu.make("Door", use_latch=use_latch, **KW)
    penv = robosuite_tpu_torch.make("Door", use_latch=use_latch, device="cpu", **KW)
    jm, pm = jenv.model, penv.model
    sizes = ("nq", "nv", "nbody", "ngeom", "nsite", "nu", "npair")
    assert tuple(getattr(pm, n) for n in sizes) == tuple(getattr(jm, n) for n in sizes)
    assert (pm.nq, pm.npair) == ((11, 60) if use_latch else (10, 42))
    rows = sum(len(r) for r in C.contact_row_layout(pm).values())
    assert rows == (170 if use_latch else 124)
    assert C.contact_row_layout(pm) == JC.contact_row_layout(jm)
    assert list(pm.pair_geom1) == list(np.asarray(jm.pair_geom1)) and list(pm.pair_geom2) == list(np.asarray(jm.pair_geom2))
    for n in ("body_pos", "body_quat", "geom_size", "jnt_range", "dof_damping", "dof_frictionloss", "jnt_stiffness",
              "qpos0"):
        np.testing.assert_allclose(getattr(pm, n).numpy(), np.asarray(getattr(jm, n)), rtol=0, atol=1e-7, err_msg=n)
    assert penv.hinge_qpos_addr == jenv.hinge_qpos_addr and penv.door_body_id == jenv.door_body_id
    assert penv.handle_site_id == jenv.handle_site_id
    if use_latch:
        assert penv.handle_qpos_addr == jenv.handle_qpos_addr
    # the door object's names and extents, and each named body and joint in the world
    names = ("door_body", "frame_body", "latch_body", "hinge_joint", "latch_joint", "important_sites", "joint_names")
    for n in names + ("bottom_offset", "top_offset", "horizontal_radius"):
        np.testing.assert_equal(getattr(penv.door, n), getattr(jenv.door, n), err_msg=n)
    for n in ("door_body", "frame_body") + (("latch_body",) if use_latch else ()):
        assert pm.body_name2id(getattr(penv.door, n)) == jm.body_name2id(getattr(jenv.door, n)), n
    assert len(penv.door.joint_names) == (2 if use_latch else 1)
    for n in penv.door.joint_names:
        assert pm.jnt_qpos_slice(n) == jm.jnt_qpos_slice(n), n
    spec, jspec = substep.extract_spec(penv, pm), jextract(jenv, jm).arm
    assert spec["ctrl_type"] == jspec.ctrl_type == "osc"
    assert spec["qp_idx"] == list(jspec.qp_idx) and spec["actuator_ids"] == list(jspec.actuator_ids)


@pytest.fixture(scope="module")
def door_kin(envs, contact):
    """JAX forward kinematics of the contact states and of two more with the
    arm moved, as numpy."""
    from robosuite_tpu.physics import kinematics as JK

    jenv, _ = envs
    rng = np.random.default_rng(0)
    qpos = np.concatenate([contact[:, 1:12], contact[:, 1:12]]).astype(np.float32)
    qpos[2:, :7] += 0.05 * rng.standard_normal((2, 7)).astype(np.float32)
    fk = jax.jit(lambda q: JK.fk(jenv.model, q))
    kins = [fk(jnp.asarray(q)) for q in qpos]
    return kins, {f: np.stack([np.asarray(getattr(k, f)) for k in kins]) for f in KIN_FIELDS}


TYPES = [(S.PLANE, S.CYLINDER), (S.PLANE, S.BOX), (S.CYLINDER, S.CYLINDER), (S.CYLINDER, S.BOX), (S.BOX, S.BOX)]
TYPE_IDS = ["plane_cylinder", "plane_box", "cylinder_cylinder", "cylinder_box", "box_box"]


@pytest.mark.parametrize("types", TYPES, ids=TYPE_IDS)
def test_narrowphase_candidates_match_jax(envs, door_kin, types):
    """Every candidate of a pair type (before the manifold cut) from the
    port's formulas equals the JAX lane formulas' on the same poses."""
    from robosuite_tpu.ops.pallas_substep import _LANE_DISPATCH as JAX_LANES

    jenv, penv = envs
    _, kin_np = door_kin
    gs = [(g1, g2) for g1, g2, _, _ in C.pair_groups(penv.model)[types]]
    g1s, g2s = [g[0] for g in gs], [g[1] for g in gs]
    size = np.asarray(jenv.model.geom_size)
    gx, gm = kin_np["geom_xpos"], kin_np["geom_xmat"]

    def operand(asarray, idx):
        return (tuple(asarray(gx[:, idx, i]) for i in range(3)),
                [[asarray(gm[:, idx, i, j]) for j in range(3)] for i in range(3)],
                tuple(asarray(size[idx, i]) for i in range(3)))

    cands_p = C._LANE_DISPATCH[types](*operand(torch.as_tensor, g1s), *operand(torch.as_tensor, g2s))
    cands_j = JAX_LANES[types](*operand(jnp.asarray, g1s), *operand(jnp.asarray, g2s))
    assert len(cands_p) == len(cands_j) == C._PAIR_POINTS[types]
    for (dp, pp, np_), (dj, pj, nj) in zip(cands_p, cands_j):
        np.testing.assert_allclose(dp.numpy(), np.broadcast_to(np.asarray(dj), dp.shape), rtol=0, atol=1e-5)
        for a, b in zip(pp + np_, pj + nj):
            a = torch.broadcast_to(torch.as_tensor(a), dp.shape).numpy()
            np.testing.assert_allclose(a, np.broadcast_to(np.asarray(b), dp.shape), rtol=0, atol=1e-5)


def test_narrowphase_matches_jax(envs, door_kin):
    """Door's whole contact buffer (170 rows): row depths, bodies and the
    per-row parameters; the per-pair minimum distances."""
    from robosuite_tpu.physics import contact as JC

    jenv, penv = envs
    kins, kin_np = door_kin
    kin_p = KinData(**{f: torch.as_tensor(v) for f, v in kin_np.items()})
    con_p = C.narrowphase(penv.model, kin_p)
    pd_p = C.pair_min_dists(penv.model, kin_p)
    assert con_p["dist"].shape[1] == 170 and float(pd_p.min()) < 0.0
    np_j = jax.jit(lambda k: JC.narrowphase(jenv.model, k))
    pd_j = jax.jit(lambda k: JC.pair_min_dists(jenv.model, k))
    for b, k in enumerate(kins):
        con_j = np_j(k)
        np.testing.assert_allclose(con_p["dist"][b].numpy(), np.asarray(con_j["dist"]), rtol=0, atol=1e-5)
        np.testing.assert_allclose(pd_p[b].numpy(), np.asarray(pd_j(k)), rtol=0, atol=1e-5)
        assert con_p["body1"] == tuple(con_j["body1"]) and con_p["body2"] == tuple(con_j["body2"])
        for f in ("friction", "solref", "solimp", "margin"):
            np.testing.assert_allclose(con_p[f].numpy(), np.asarray(con_j[f]), rtol=0, atol=1e-7)


def _quat_axis_angle(axis, ang):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    return np.concatenate([[np.cos(ang / 2)], np.sin(ang / 2) * axis])


# (name, plane?, [(pos, quat, radius, half length)] of free cylinders, in contact 1 mm deep)
PAIR_WORLDS = [
    ("plane_cylinder_tilted", True,
     [((0.0, 0.0, 0.05 * np.cos(0.4) + 0.03 * np.sin(0.4) - 0.001), _quat_axis_angle((1, 0, 0), 0.4), 0.03, 0.05)]),
    ("plane_cylinder_upright", True, [((0.1, 0.0, 0.049), (1.0, 0.0, 0.0, 0.0), 0.03, 0.05)]),
    ("cylinder_cylinder_crossed", False,
     [((0.0, 0.0, 0.0), _quat_axis_angle((0, 1, 0), np.pi / 2), 0.03, 0.08),
      ((0.01, 0.02, 0.049), _quat_axis_angle((1, 0, 0), np.pi / 2 + 0.2), 0.02, 0.06)]),
    ("cylinder_cylinder_parallel", False,
     [((0.0, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0), 0.03, 0.05), ((0.049, 0.0, 0.02), (1.0, 0.0, 0.0, 0.0), 0.02, 0.05)]),
]


def pair_world(spec, plane, cylinders):
    """A world of the given free cylinders (and a floor plane): -> (ModelSpec,
    qpos (nq,)), the free joints at the cylinders' poses."""
    ms = spec.ModelSpec("pairs")
    if plane:
        ms.worldbody.add_geom(spec.GeomSpec("floor", type="plane", size=(1.0, 1.0, 0.1)))
    qpos = []
    for i, (pos, quat, r, h) in enumerate(cylinders):
        b = ms.worldbody.add_body(spec.BodySpec(f"c{i}"))
        b.add_joint(spec.JointSpec(f"j{i}", type="free"))
        b.add_geom(spec.GeomSpec(f"g{i}", type="cylinder", size=(r, h)))
        qpos += list(pos) + list(quat)
    return ms, np.asarray(qpos, np.float32)


def pair_world_models(plane, cylinders):
    """The JAX model of a pair world, the port's copy of it, and its qpos."""
    from robosuite_tpu.models import spec as JS

    ms, qpos = pair_world(JS, plane, cylinders)
    jm = ms.compile()
    pm = convert.model_from_numpy({n: np.asarray(getattr(jm, n)) for n in PM.LEAVES},
                                  {n: getattr(jm, n) for n in PM.STATIC}, device="cpu")
    return jm, pm, qpos


@pytest.mark.parametrize("world", PAIR_WORLDS, ids=[w[0] for w in PAIR_WORLDS])
def test_new_pair_kinds_touching_match_jax(world):
    """Plane-cylinder (3 points: both rims and the +z cap's centre; the
    rim falls back to the cylinder's x axis when its axis is parallel to
    the plane normal) and cylinder-cylinder (1 point: the closest points of
    the axes, parallel axes included) in contact, against the JAX
    narrowphase (contact.py _plane_cylinder, _capsule_capsule): depths,
    points and normals 1e-5."""
    from robosuite_tpu.physics import contact as JC
    from robosuite_tpu.physics import kinematics as JK

    _, plane, cyls = world
    jm, pm, qpos = pair_world_models(plane, cyls)
    con_j = JC.narrowphase(jm, JK.fk(jm, jnp.asarray(qpos)))
    con_p = C.narrowphase(pm, kinematics.fk(pm, torch.as_tensor(qpos)[None]))
    assert float(con_p["dist"].min()) < 0.0  # touching
    np.testing.assert_allclose(con_p["dist"][0].numpy(), np.asarray(con_j["dist"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(con_p["pos"][0].numpy(), np.asarray(con_j["pos"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(con_p["normal"][0].numpy(), np.asarray(con_j["normal"]), rtol=0, atol=1e-5)


def test_substep_matches_jax(envs, contact):
    from robosuite_tpu.ops.pallas_substep import make_fused_substep

    jenv, penv = envs
    jm, pm = jenv.model, penv.model
    flat = _limits(penv, contact)
    qpos, qvel = flat[:, 1:1 + pm.nq], flat[:, 1 + pm.nq:]
    B = qpos.shape[0]
    rng = np.random.default_rng(2)
    ps = penv.state_from_flattened(flat)
    kin = forward.forward_products(pm, ps.physics.qpos, ps.physics.qvel)[0]
    goal, gains = penv._fused_goal_fn(penv.robots[0], "right", ps.ctrl, kin)
    goal = goal + torch.as_tensor(0.01 * rng.standard_normal(goal.shape), dtype=torch.float32)
    grip = torch.as_tensor(np.tile([[0.5, -0.5]], (B, 1)), dtype=torch.float32)
    leaves = forward.runtime_leaves(pm, B)
    qp_p, qv_p, f_p = substep.substep_plain(penv, pm, torch.as_tensor(qpos), torch.as_tensor(qvel), *leaves, goal,
                                            gains, grip)
    assert f_p.shape == (B, 510)
    jfused = jax.jit(make_fused_substep(jenv, jm))
    for b in range(B):
        qp_j, qv_j, f_j = jfused(jnp.asarray(qpos[b]), jnp.asarray(qvel[b]), jm.body_mass, jm.body_inertia, jm.gravity,
                                 jm.dof_armature, jnp.asarray(goal[b].numpy()), jnp.asarray(gains[b].numpy()),
                                 jnp.asarray(grip[b].numpy()))
        np.testing.assert_allclose(qp_p[b].numpy(), np.asarray(qp_j), rtol=0, atol=1e-5)
        np.testing.assert_allclose(qv_p[b].numpy(), np.asarray(qv_j), rtol=0, atol=1e-4)
        np.testing.assert_allclose(f_p[b].numpy(), np.asarray(f_j), rtol=0,
                                   atol=1e-4 * max(1.0, float(np.abs(np.asarray(f_j)).max())))


def jax_step_batch(jenv):
    """The JAX env's step_batch one scenario at a time: XLA:CPU compiles the
    unbatched _step_impl in about two thirds of the vmapped one's time, and
    each scenario's step is the same."""
    step = jax.jit(jenv._step_impl)

    def run(states, actions):
        outs = [step(jax.tree_util.tree_map(lambda x: x[b], states), actions[b]) for b in range(actions.shape[0])]
        return jax.tree_util.tree_map(lambda *x: jnp.stack(x), *outs)

    return run


WRENCH = ("robot0_eef_force", "robot0_eef_torque")


def hold_obs(penv, po, jo, tol, label):
    """Every observation of the port (po) against the JAX package's (jo),
    each value at `tol`, the eef force and torque (newtons, from the solver
    forces) at 1e-3 of their largest; the '<modality>-state' vectors per
    element at the tolerance of the value the element comes from."""
    B = next(iter(po.values())).shape[0]
    scale = {k: 1e-3 * max(1.0, float(np.abs(np.asarray(jo[k])).max())) if k in WRENCH else tol for k in jo}
    parts = {}
    for ob in penv._observables_for([k for k in po if not k.endswith("-state")]):
        parts.setdefault(f"{ob.modality}-state", []).append(ob.name)
        scale[f"{ob.modality}-state"] = None
    for k, want in jo.items():
        want, got = np.asarray(want), po[k].numpy()
        if scale[k] is None:
            atol = np.concatenate([np.full(np.asarray(jo[n]).reshape(B, -1).shape[1], scale[n]) for n in parts[k]])
            assert got.shape == want.shape == (B, atol.size), f"{label}: {k}"
            bad = np.abs(got - want) > atol
            assert not bad.any(), f"{label}: {k} differs at {np.argwhere(bad).tolist()}"
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=scale[k], err_msg=f"{label}: {k}")


def test_step_batch_matches_jax(envs, contact):
    """Five step_batch policy steps from the contact states injected into
    both packages (state_from_flattened), horizon 3."""
    jenv, penv = envs
    B = contact.shape[0]
    from_flat = jax.jit(jenv.state_from_flattened)
    js = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *[from_flat(jnp.asarray(f)) for f in contact])
    ps = penv.state_from_flattened(contact)
    rng = np.random.default_rng(1)
    acts = np.clip(0.5 * rng.standard_normal((5, B, penv.action_dim)), -1, 1).astype(np.float32)
    acts[:, :, 6] = 1.0  # keep closing on the handle
    wrench = []
    jstep = jax_step_batch(jenv)
    for i in range(5):
        js, jo, jr, jd, _ = jstep(js, jnp.asarray(acts[i]))
        ps, po, pr, pd, _ = penv.step_batch(ps, torch.as_tensor(acts[i]))
        assert set(po) == set(jo)
        if i == 0:
            np.testing.assert_allclose(ps.physics.qpos.numpy(), np.asarray(js.physics.qpos), rtol=0, atol=1e-4)
            np.testing.assert_allclose(ps.physics.qvel.numpy(), np.asarray(js.physics.qvel), rtol=0, atol=1e-4)
        hold_obs(penv, po, jo, 1e-4 if i == 0 else 1e-3, f"step {i}")
        np.testing.assert_allclose(pr.numpy(), np.asarray(jr), rtol=0, atol=1e-4 if i == 0 else 1e-3)
        np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
        assert ps.t.tolist() == [i + 1] * B
        wrench.append(float(np.abs(np.asarray(jo["robot0_eef_force"])).max()))
    assert max(wrench) > 0.1  # the finger pads push on the handle


def test_door_residual_matches_jax(envs, contact):
    from robosuite_tpu.mpc import residuals as jres

    from robosuite_tpu_torch.mpc import residuals

    jenv, penv = envs
    flat = _limits(penv, contact)
    qpos, qvel = flat[:, 1:12], flat[:, 12:]
    u = np.zeros((2, penv.action_dim), np.float32)
    assert residuals.residual_for(penv) is residuals.door_residual
    r_p = residuals.door_residual(penv, penv.model, torch.as_tensor(qpos), torch.as_tensor(qvel), torch.as_tensor(u))
    for b in range(2):
        r_j = jres.door_residual(jenv, jenv.model, jnp.asarray(qpos[b]), jnp.asarray(qvel[b]), jnp.asarray(u[b]))
        np.testing.assert_allclose(r_p[b].numpy(), np.asarray(r_j), rtol=0, atol=1e-5)


def test_reset_and_fused_unfused_agree(envs):
    """reset_batch gives finite observations with the eef wrench at zero and
    the placement flag; the fused and the unfused plain paths agree."""
    _, penv = envs
    states, obs = penv.reset_batch(2, torch.Generator().manual_seed(3))
    assert {"door_pos", "handle_qpos", "hinge_qpos", "object-state", "robot0_proprio-state"} <= set(obs)
    assert all(torch.isfinite(v.float()).all() for v in obs.values()) and bool(obs["placement_valid"].all())
    assert not bool(obs["robot0_eef_force"].any()) and obs["object-state"].shape == (2, 14)
    a = torch.full((2, penv.action_dim), 0.3)
    s1, r1 = penv.rollout_batch(states, a)
    penv._disable_fused = True
    try:
        s2, r2 = penv.rollout_batch(states, a)
    finally:
        penv._disable_fused = False
    torch.testing.assert_close(s1.physics.qpos, s2.physics.qpos, rtol=0, atol=1e-6)
    torch.testing.assert_close(r1, r2, rtol=0, atol=1e-6)
    assert engine.forward_products.launches == 0
