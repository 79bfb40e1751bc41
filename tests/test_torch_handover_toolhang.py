"""TwoArmHandover (two Pandas, OSC_POSE, "opposed") and ToolHang (a Panda,
OSC_POSE): the port on the CPU (its plain path) against the JAX package on
the same inputs.

  * each world: every compiled leaf 1e-7, the static structure exactly
    (the pair list and its order), the contact row layout, the row
    compaction and the action width; the composite objects' offsets and
    radii;
  * the fused substep's gate refuses TwoArmHandover for its two robots and
    ToolHang for its row compaction (UnsupportedFused, the JAX predicate);
    K1's table takes both; the "single-robot" configuration with a
    one-arm robot raises;
  * the reset placements: the sampler's ranges (the stand fixed and not
    turned), and a JAX reset injected into the port (state_from_flattened)
    giving the JAX reset's observations (1e-5);
  * the observations (every key), the reward and _check_success (1e-5) on
    the same poses: the contact states (ab_kernels.handover_contact_state,
    tool_hang_contact_state), TwoArmHandover's lift, hover and success
    branches and ToolHang's success branch with their poses and pair
    distances injected into both packages' kin;
  * step_batch against rollout_batch from the same states, bit for bit,
    and its observations against the JAX env's after one policy step;
  * RecedingMPC builds the MPPI-only solve on an env with no ported
    residual (ToolHang) and raises NotImplementedError for the iLQR.

One substep, one policy step and one MPPI solve of each world are held in
tests/test_torch_last_envs_step.py.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robosuite_tpu_torch import ab_kernels
from robosuite_tpu_torch.models import model as PM
from robosuite_tpu_torch.ops import substep, tables
from robosuite_tpu_torch.physics import contact as C
from robosuite_tpu_torch.physics import kinematics
from robosuite_tpu_torch.physics.state import KinData

NAMES = ("TwoArmHandover", "ToolHang")
MAKE = {"TwoArmHandover": dict(robots=("Panda", "Panda")), "ToolHang": dict(robots="Panda")}
# (nq, nv, nbody, ngeom, nsite, nu, npair, candidate rows): chip_smoke.py's world tuples
SIZES = {"TwoArmHandover": (25, 24, 47, 161, 17, 18, 62, 203), "ToolHang": (30, 27, 28, 102, 14, 9, 172, 656)}
STATE_FN = {"TwoArmHandover": ab_kernels.handover_contact_state, "ToolHang": ab_kernels.tool_hang_contact_state}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_ENVS = {}


def envs(name):
    """(the JAX env, the port's CPU env), made once per module."""
    if name not in _ENVS:
        import robosuite_tpu
        import robosuite_tpu_torch

        _ENVS[name] = (robosuite_tpu.make(name, reward_shaping=True, **MAKE[name]),
                       robosuite_tpu_torch.make(name, reward_shaping=True, device="cpu", **MAKE[name]))
    return _ENVS[name]


def _static(v):
    return tuple(v) if isinstance(v, (list, tuple)) else v


def hold_world(jenv, penv, sizes):
    """Every compiled leaf 1e-7 and every static field of the port's world
    against the JAX package's; the sizes, the pairs, the row layout and
    compaction, the action width and bounds."""
    from robosuite_tpu.physics import contact as JC

    jm, pm = jenv.model, penv.model
    for field in PM.LEAVES:
        a, b = np.asarray(getattr(jm, field), dtype=np.float64), getattr(pm, field).numpy().astype(np.float64)
        assert a.shape == b.shape, field
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-7, err_msg=field)
    for field in PM.STATIC:
        assert _static(getattr(pm, field)) == _static(getattr(jm, field)), field
    nrows = sum(len(r) for r in C.contact_row_layout(pm).values())
    assert (pm.nq, pm.nv, pm.nbody, pm.ngeom, pm.nsite, pm.nu, pm.npair, nrows) == sizes
    assert [(pm.pair_geom1[k], pm.pair_geom2[k]) for k in range(pm.npair)] == [
        (int(jm.pair_geom1[k]), int(jm.pair_geom2[k])) for k in range(jm.npair)]
    assert C.contact_row_layout(pm) == JC.contact_row_layout(jm)
    assert C.uses_row_compaction(pm) and JC.uses_row_compaction(jm)
    assert C.contact_warmstart_dim(pm) == JC.contact_warmstart_dim(jm) == 3 * C.ROW_CAP
    assert penv.action_dim == jenv.action_dim
    lo, hi = penv.action_spec
    jlo, jhi = jenv.action_spec
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)


def hold_objects(pairs):
    """Each (port object, JAX object): names, sites, offsets and radius."""
    for p, j in pairs:
        assert (p.root_body, p.contact_geoms) == (j.root_body, j.contact_geoms)
        assert getattr(p, "important_sites", None) == getattr(j, "important_sites", None)
        np.testing.assert_array_equal(p.bottom_offset, j.bottom_offset)
        np.testing.assert_array_equal(p.top_offset, j.top_offset)
        assert p.horizontal_radius == j.horizontal_radius


@pytest.mark.parametrize("name", NAMES)
def test_world_matches_jax(name):
    jenv, penv = envs(name)
    hold_world(jenv, penv, SIZES[name])
    if name == "TwoArmHandover":
        hold_objects([(penv.hammer, jenv.hammer)])
        assert penv.eef_sites == jenv.eef_sites and penv.hammer_body_id == jenv.hammer_body_id
        assert [tuple(p) for p in (penv._grasp0, penv._grasp1)] == [
            tuple(jenv._rows_to_pairs(r) for r in rows) for rows in (jenv._grasp0, jenv._grasp1)]
    else:
        hold_objects([(penv.stand, jenv.stand), (penv.frame, jenv.frame), (penv.tool, jenv.tool)])
        for f in ("stand_body_id", "frame_body_id", "tool_body_id", "frame_hang_site", "frame_intersect_site",
                  "tool_ring_site", "eef_site"):
            assert getattr(penv, f) == getattr(jenv, f), f


@pytest.mark.parametrize("name", NAMES)
def test_fused_gate_refuses_the_world_and_k1_takes_it(name):
    """The fused substep's gate refuses TwoArmHandover for its two robots
    and ToolHang for its row compaction (the JAX predicate), so every
    substep runs unfused; K1's table (no contact part) takes both."""
    from robosuite_tpu.ops import pallas_substep as JPS

    jenv, penv = envs(name)
    pm = penv.model
    with pytest.raises(substep.UnsupportedFused, match={"TwoArmHandover": "one fixed-base robot",
                                                        "ToolHang": "compacts"}[name]):
        substep.extract_spec(penv, pm)
    with pytest.raises(JPS.UnsupportedFused):
        JPS.extract_spec(jenv, jenv.model)
    assert penv._fused_for(pm) is None and penv._fused_for(pm, emit_aux=True) is None
    assert tables.check_model(pm, contacts=False) == 0


def test_handover_single_robot_configuration_raises():
    """One robot selects the single-robot configuration, which needs a
    bimanual robot: a Panda is refused (ValueError), as robosuite's
    configuration check refuses it."""
    import robosuite_tpu_torch

    with pytest.raises(ValueError, match="single-robot"):
        robosuite_tpu_torch.make("TwoArmHandover", robots="Panda", device="cpu")


def test_placements():
    """TwoArmHandover's hammer at x in [-0.1, 0.1], y in [-0.05, 0.05] about
    the table's centre, its head's bottom 1 cm above the table top, turned
    about z over [0, 2 pi); ToolHang's stand at (-0.08, 0.16) unturned, the
    frame at x in [-0.12, -0.08], y in [-0.22, -0.18] and the wrench at y in
    [-0.05, 0.05], each 1 mm above the table; where a scenario's placement
    is valid, each object clear of those placed before it by their
    horizontal radii (ToolHang's ranges leave the wrench no clear spot in
    some draws, in the JAX package too: its reset flags them invalid)."""
    n = 512
    _, penv = envs("TwoArmHandover")
    idx, vals, valid = penv._sample_placements(torch.Generator().manual_seed(9), n)
    start = penv.model.jnt_qpos_slice("hammer_joint0").start
    assert idx == list(range(start, start + 7)) and bool(valid.all())
    assert bool((vals[:, 0].abs() <= 0.1 + 1e-6).all() and (vals[:, 1].abs() <= 0.05 + 1e-6).all())
    torch.testing.assert_close(vals[:, 2], torch.full((n,), 0.8 + 0.01 + 0.03), rtol=0, atol=1e-6)
    angle = torch.remainder(2.0 * torch.atan2(vals[:, 6], vals[:, 3]), 2 * math.pi)
    assert float(angle.min()) < 0.5 and float(angle.max()) > 2 * math.pi - 0.5
    _, penv = envs("ToolHang")
    idx, vals, valid = penv._sample_placements(torch.Generator().manual_seed(9), n)
    assert bool(valid.any())
    xy = [vals[:, 7 * i:7 * i + 2] for i in range(3)]
    radii = [o.horizontal_radius for o in (penv.stand, penv.frame, penv.tool)]
    for i in range(3):
        for j in range(i):
            d = torch.linalg.vector_norm(xy[i] - xy[j], dim=-1)
            assert bool((d[valid] > radii[i] + radii[j]).all())
    for i, (obj, (xr, yr)) in enumerate(zip((penv.stand, penv.frame, penv.tool),
                                             (((-0.08, -0.08), (0.16, 0.16)), ((-0.12, -0.08), (-0.22, -0.18)),
                                              ((-0.12, -0.08), (-0.05, 0.05))))):
        start = penv.model.jnt_qpos_slice(f"{obj.name}_joint0").start
        assert idx[7 * i:7 * i + 7] == list(range(start, start + 7))
        v = vals[:, 7 * i:7 * i + 7]
        assert bool(((v[:, 0] >= xr[0] - 1e-6) & (v[:, 0] <= xr[1] + 1e-6)).all())
        assert bool(((v[:, 1] >= yr[0] - 1e-6) & (v[:, 1] <= yr[1] + 1e-6)).all())
        torch.testing.assert_close(v[:, 2], torch.full((n,), 0.8 + 0.001 - float(obj.bottom_offset[2])), rtol=0,
                                   atol=1e-6)
    torch.testing.assert_close(vals[:, 3:7], torch.tensor([[1.0, 0.0, 0.0, 0.0]]).expand(n, 4), rtol=0, atol=0)


def _jkin(kin, b):
    from robosuite_tpu.physics.state import KinData as JKin

    return JKin(**{f: jnp.asarray(v[b].numpy()) for f, v in kin.__dict__.items() if v is not None})


def _jphys(phys, b):
    from robosuite_tpu.physics.state import State as JState

    return JState(qpos=jnp.asarray(phys.qpos[b].numpy()), qvel=jnp.asarray(phys.qvel[b].numpy()),
                  time=jnp.asarray(float(phys.time[b])))


_PIECES = {}


def _jax_pieces(jenv):
    """The JAX env's observations, reward and success on one scenario's
    physics state and kin, jitted."""
    if id(jenv) not in _PIECES:
        def pieces(phys, kin):
            return jenv._get_observations(phys, kin), jenv.reward(None, phys, kin), jenv._check_success(phys, kin)

        _PIECES[id(jenv)] = jax.jit(pieces)
    return _PIECES[id(jenv)]


def hold_pieces(jenv, penv, phys, kin):
    """The port's observations, reward and success against the JAX env's
    on the same physics state and kin, scenario by scenario (1e-5)."""
    obs = penv._get_observations(phys, kin)
    r = penv.reward(phys, kin)
    ok = penv._check_success(kin)
    for b in range(phys.qpos.shape[0]):
        obs_j, r_j, ok_j = _jax_pieces(jenv)(_jphys(phys, b), _jkin(kin, b))
        assert set(obs_j) == set(obs)
        for k, v in obs_j.items():
            np.testing.assert_allclose(obs[k][b].numpy(), np.asarray(v), rtol=0, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(float(r[b]), float(r_j), rtol=0, atol=1e-5)
        assert bool(ok[b]) == bool(ok_j)
    return r, ok


def hold_jax_reset(jenv, penv, key_seed, n):
    """n JAX resets injected into the port (state_from_flattened): the
    port's observations of them against the JAX reset's (1e-5). -> the
    injected states."""
    from robosuite_tpu.physics import engine as JE

    js, jobs = jax.jit(jax.vmap(jenv._reset_jit))(jax.random.split(jax.random.PRNGKey(key_seed), n))
    flat = jax.jit(jax.vmap(lambda s: jnp.concatenate([s.physics.time[None], s.physics.qpos, s.physics.qvel])))(js)
    ps = penv.state_from_flattened(np.asarray(flat))
    kin = kinematics.fk(penv.model, ps.physics.qpos)
    obs = penv._get_observations(ps.physics, kin)
    for k, v in obs.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jobs[k]), rtol=0, atol=1e-5, err_msg=k)
    jk = jax.jit(jax.vmap(lambda s: JE.forward_products(jenv.model, s.physics)[0].xpos))(js)
    np.testing.assert_allclose(kin.xpos.numpy(), np.asarray(jk), rtol=0, atol=1e-5)
    return ps


@pytest.mark.parametrize("name", NAMES)
def test_jax_reset_injected_matches(name):
    """Four JAX resets injected into the port: the same observations and
    body poses (1e-5); the objects where the placement ranges put them."""
    jenv, penv = envs(name)
    ps = hold_jax_reset(jenv, penv, 5, 4)
    q = ps.physics.qpos
    if name == "TwoArmHandover":
        a = penv.model.jnt_qpos_slice("hammer_joint0").start
        assert bool((q[:, a].abs() <= 0.1 + 1e-6).all()) and bool((q[:, a + 1].abs() <= 0.05 + 1e-6).all())
    else:
        a = penv.model.jnt_qpos_slice("stand_joint0").start
        torch.testing.assert_close(q[:, a:a + 2], torch.tensor([[-0.08, 0.16]]).expand(4, 2), rtol=0, atol=1e-6)


def _with_pairs(kin, touching, lifted):
    """A copy of kin whose pair distances (pair_dist, which both packages'
    contact queries read first) touch at the pairs `touching` and nowhere
    else, with the hammer's body lifted to z 1.0 in the scenarios
    `lifted`."""
    penv = envs("TwoArmHandover")[1]
    pd = torch.ones(kin.xpos.shape[0], penv.model.npair)
    for pairs in touching:
        pd[:, pairs] = -1e-3
    out = KinData(**{f: v.clone() for f, v in kin.__dict__.items() if v is not None and f != "pair_dist"},
                  pair_dist=pd)
    out.xpos[lifted, penv.hammer_body_id, 2] = 1.0
    return out


def test_handover_reward_observations_success_match_jax():
    """At robot0's grasp of the handle's end (handover_contact_state, 4
    scenarios): observations, the shaped reward (robot0's reach) and
    success against the JAX env's; then the pair distances injected into
    both kins: robot0's pads on the handle and the hammer lifted in the
    last two scenarios (the lift and hover terms), and robot1's pads on it,
    robot0's off and the hammer lifted (the success branch: 2, scaled to
    1)."""
    jenv, penv = envs("TwoArmHandover")
    s, _ = penv.reset_batch(4, torch.Generator().manual_seed(1))
    s = ab_kernels.handover_contact_state(penv, s)
    kin = kinematics.fk(penv.model, s.physics.qpos)
    assert bool(penv.check_grasp(kin, *penv._grasp0).all()) and not bool(penv.check_grasp(kin, *penv._grasp1).any())
    r, ok = hold_pieces(jenv, penv, s.physics, kin)
    assert not bool(ok.any()) and float(r.max()) < 0.06
    r, ok = hold_pieces(jenv, penv, s.physics, _with_pairs(kin, penv._grasp0, [2, 3]))
    assert not bool(ok.any()) and float(r[2:].min()) > 0.25 and float(r[:2].max()) < 0.06
    r, ok = hold_pieces(jenv, penv, s.physics, _with_pairs(kin, penv._grasp1, [0, 1, 2, 3]))
    assert bool(ok.all()) and torch.allclose(r, torch.ones(4))


def test_tool_hang_reward_observations_success_match_jax():
    """At the pads' grasp of the wrench (tool_hang_contact_state):
    observations, the sparse reward (0) and success against the JAX env's;
    then the frame set upright in the stand's mount and the wrench's ring
    hung 5 cm under the hook's tip, injected into both kins: the success
    branch (1)."""
    jenv, penv = envs("ToolHang")
    s, _ = penv.reset_batch(2, torch.Generator().manual_seed(2))
    s = ab_kernels.tool_hang_contact_state(penv, s)
    kin = kinematics.fk(penv.model, s.physics.qpos)
    r, ok = hold_pieces(jenv, penv, s.physics, kin)
    assert not bool(ok.any()) and not bool(r.any())
    hang = KinData(**{f: v.clone() for f, v in kin.__dict__.items() if v is not None})
    top = hang.xpos[:, penv.stand_body_id] + torch.tensor([0.0, 0.0, 0.21])
    hang.xmat[:, penv.frame_body_id] = torch.eye(3)
    hang.site_xpos[:, penv.frame_intersect_site] = top + torch.tensor([0.01, 0.0, -0.05])
    tip = hang.site_xpos[:, penv.frame_intersect_site] + torch.tensor([0.075, 0.0, 0.22])
    hang.site_xpos[:, penv.frame_hang_site] = tip
    hang.site_xpos[:, penv.tool_ring_site] = tip + torch.tensor([0.01, -0.01, -0.05])
    r, ok = hold_pieces(jenv, penv, s.physics, hang)
    assert bool(ok.all()) and torch.equal(r, torch.ones(2))
    assert bool(penv._check_frame_assembled(hang).all()) and bool(penv._check_tool_on_frame(hang).all())


@pytest.mark.parametrize("name", NAMES)
def test_step_batch_matches_rollout_batch_and_jax_observations(name):
    """Two step_batch policy steps (the plain unfused path) from a reset
    against rollout_batch from the same states: the same physics, goals
    and rewards bit for bit; the observations against the JAX env's at the
    post-step states, every robot's eef force and torque zero (a
    compacting world, as in the JAX package), a proprio modality per
    robot."""
    jenv, penv = envs(name)
    s, obs0 = penv.reset_batch(2, torch.Generator().manual_seed(3))
    a = torch.clamp(0.5 * torch.randn(2, penv.action_dim, generator=torch.Generator().manual_seed(4)), -1, 1)
    for _ in range(2):
        s2, obs, r, done, info = penv.step_batch(s, a)
        s3, r3 = penv.rollout_batch(s, a)
        for x, y in ((s2.physics.qpos, s3.physics.qpos), (s2.physics.qvel, s3.physics.qvel), (r, r3)):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
        for c2, c3 in zip(penv._unpack_ctrl(s2.ctrl), penv._unpack_ctrl(s3.ctrl)):
            torch.testing.assert_close(c2.arm["right"].goal_pos, c3.arm["right"].goal_pos, rtol=0, atol=0)
        s = s2
    assert not bool(done.any()) and info == {} and set(obs) == set(obs0) - {"placement_valid"}
    for i in range(len(penv.robots)):
        for k in (f"robot{i}_eef_force", f"robot{i}_eef_torque"):
            assert obs[k].shape == (2, 3) and not bool(obs[k].any())
        assert obs[f"robot{i}_proprio-state"].shape[0] == 2
    kin = kinematics.fk(penv.model, s.physics.qpos)
    hold_pieces(jenv, penv, s.physics, kin)


def test_mpc_builds_mppi_only_without_a_residual():
    """ToolHang has no ported residual (nor has the JAX package one): the
    MPPI-only solve (n_ilqr_iters=0) builds and runs a tick, finite actions
    in [-1, 1]; the iLQR (n_ilqr_iters=1) raises NotImplementedError naming
    the env, where the JAX package would fail in lift_residual."""
    from robosuite_tpu_torch.mpc import receding, residuals

    _, penv = envs("ToolHang")
    assert residuals.residual_for(penv) is None
    cfg = dict(horizon=2, n_samples=2, noise_sigma=0.4, temperature=0.2, n_knots=2, plan_timestep=0.05)
    mpc = receding.RecedingMPC(penv, receding.MPCConfig(n_ilqr_iters=0, **cfg))
    s, _ = penv.reset_batch(1, torch.Generator().manual_seed(6))
    a, ms, _ = mpc.make_solve_batch()(s, mpc.init_state(1, torch.Generator().manual_seed(7)))
    assert a.shape == (1, penv.action_dim) and bool(torch.isfinite(a).all()) and float(a.abs().max()) <= 1.0
    with pytest.raises(NotImplementedError, match="ToolHang"):
        receding.RecedingMPC(penv, receding.MPCConfig(n_ilqr_iters=1, **cfg))
