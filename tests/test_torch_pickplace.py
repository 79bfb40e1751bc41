"""The Sawyer + PickPlaceCan slice with the JOINT_POSITION controller: the
port on the CPU (its plain path) against the JAX package on the same
inputs.

  * the world: every compiled leaf (the convex hulls' padded vertices and
    face planes, the hull bodies' masses and inertias among them) 1e-7,
    the static structure exactly; the sizes, the 606 pairs and 1326 rows,
    the row compaction and the solver's force vector (288);
  * the fused substep's gate refuses the world for its row compaction,
    and K1's table takes it whatever its pairs;
  * at chip_smoke.py's contact state (ab_kernels.pickplace_contact_state,
    the pads closed on the can), and with the can moved into its target
    quadrant of bin 2: the observations, the reward and the staged rewards
    and _check_success against the JAX env's on the same poses (1e-5);
    step_batch's observations after one policy step against the JAX
    env's at the same post-step state, its eef force and torque zero (the
    JAX package gives no wrench on a compacting world);
  * pick_place_residual against the JAX one (1e-5), and the PickPlaceCan
    registry row steering toward object 0, the milk carton, as the JAX
    registry's does;
  * the placements: the four objects inside bin 1, apart by their radii.

One substep and one policy step are held in tests/test_torch_pickplace_step.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robosuite_tpu_torch import ab_kernels
from robosuite_tpu_torch.models import model as PM
from robosuite_tpu_torch.ops import substep, tables
from robosuite_tpu_torch.physics import contact as C
from robosuite_tpu_torch.physics import engine

KW = dict(robots="Sawyer", controller_configs="JOINT_POSITION", reward_shaping=True)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def envs():
    import robosuite_tpu
    import robosuite_tpu_torch

    return robosuite_tpu.make("PickPlaceCan", **KW), robosuite_tpu_torch.make("PickPlaceCan", device="cpu", **KW)


@pytest.fixture(scope="module")
def states(envs):
    """The port's contact state (2 scenarios), the second with the can
    moved into its target quadrant of bin 2, 5 cm above its floor."""
    _, penv = envs
    s, _ = penv.reset_batch(2, torch.Generator().manual_seed(1))
    s = ab_kernels.pickplace_contact_state(penv, s)
    qpos = s.physics.qpos.clone()
    can = penv.model.jnt_qpos_slice("Can_joint0").start
    qpos[1, can:can + 3] = torch.as_tensor(penv.target_bin_placements[3], dtype=torch.float32) + torch.tensor(
        [0.0, 0.0, 0.05])
    return penv.state_from_flattened(torch.cat([s.physics.time[:, None], qpos, s.physics.qvel], 1))


def _static(v):
    return tuple(v) if isinstance(v, (list, tuple)) else v


def test_world_matches_jax(envs):
    jenv, penv = envs
    jm, pm = jenv.model, penv.model
    for name in PM.LEAVES:
        a, b = np.asarray(getattr(jm, name), dtype=np.float64), getattr(pm, name).numpy().astype(np.float64)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-7, err_msg=name)
    for name in PM.STATIC:
        assert _static(getattr(pm, name)) == _static(getattr(jm, name)), name
    sizes = ("nq", "nv", "nbody", "ngeom", "nsite", "nu", "njnt", "npair", "nmesh")
    assert tuple(getattr(pm, n) for n in sizes) == (37, 33, 40, 105, 11, 9, 13, 606, 4)
    assert pm.mesh_verts.shape == (4, 32, 3) and pm.mesh_fnorm.shape == (4, 40, 3)
    # the hull bodies carry the hulls' mass and inertia at the cards' density
    for o in penv.objects:
        b = pm.body_name2id(o.root_body)
        assert 0.0 < float(pm.body_mass[b]) < 1.0 and bool((pm.body_inertia[b] > 0).all())
    from robosuite_tpu.physics import contact as JC

    assert C.contact_row_layout(pm) == JC.contact_row_layout(jm)
    assert sum(len(r) for r in C.contact_row_layout(pm).values()) == 1326
    assert C.uses_row_compaction(pm) and JC.uses_row_compaction(jm)
    assert C.contact_warmstart_dim(pm) == JC.contact_warmstart_dim(jm) == 288
    assert penv.action_dim == jenv.action_dim == 8
    assert penv.obj_body_ids == jenv.obj_body_ids and penv.eef_site == jenv.eef_site
    np.testing.assert_allclose(penv.target_bin_placements, jenv.target_bin_placements, rtol=0, atol=1e-12)


def test_fused_gate_refuses_compaction_and_k1_takes_the_world(envs):
    """The fused substep's gate refuses PickPlaceCan by its row compaction
    (the JAX predicate, before any maxima check), so its env steps take the
    unfused path; K1's table (no contact part) takes the world, while the
    fused substep's table would refuse its 606 pairs."""
    _, penv = envs
    pm = penv.model
    with pytest.raises(substep.UnsupportedFused, match="compacts its contact rows"):
        substep.extract_spec(penv, pm)
    assert penv._fused_for(pm) is None and penv._fused_for(pm, emit_aux=True) is None
    assert tables.check_model(pm, contacts=False) == 0
    t = tables.fill(pm)
    assert (t.nv, t.nbody, t.ngeom, t.npair, t.nrows) == (33, 40, 105, 0, 0)
    with pytest.raises(ValueError, match="npair=606"):
        tables.check_model(pm)


def _jax_pieces(jenv):
    """The JAX env's observations, reward, staged rewards and success on one
    scenario's physics state, jitted."""
    from robosuite_tpu.physics import engine as JE

    def pieces(phys):
        kin = JE.forward_products(jenv.model, phys)[0]
        in_bins = jenv._objects_in_bins(kin)
        return (jenv._get_observations(phys, kin), jenv.reward(None, phys, kin),
                jnp.stack(jenv._staged_rewards(kin, in_bins)), jenv._check_success(phys, kin))

    return jax.jit(pieces)


def _jax_phys(s, b):
    from robosuite_tpu.physics.state import State as JState

    return JState(qpos=jnp.asarray(s.physics.qpos[b].numpy()), qvel=jnp.asarray(s.physics.qvel[b].numpy()),
                  time=jnp.asarray(float(s.physics.time[b])))


def test_reward_observations_success_match_jax(envs, states):
    """The observations, the shaped reward, the four staged rewards and
    _check_success on the same poses: the pads on the can (grasp and
    reach), and the can inside its bin 2 quadrant (the bin reward and
    success)."""
    jenv, penv = envs
    s = states
    kin = engine.forward_products(penv.model, s.physics.qpos, s.physics.qvel)[0]
    obs = penv._get_observations(s.physics, kin)
    r = penv.reward(s.physics, kin)
    in_bins = penv._objects_in_bins(kin)
    staged = torch.stack(penv._staged_rewards(kin, in_bins), dim=-1)
    ok = penv._check_success(kin)
    assert bool(staged[0, 1] > 0) and bool(ok[1]) and not bool(ok[0])  # a grasp in 0, the can in its bin in 1
    pieces = _jax_pieces(jenv)
    for b in range(2):
        obs_j, r_j, staged_j, ok_j = pieces(_jax_phys(s, b))
        assert set(obs_j) == set(obs)
        for k, v in obs_j.items():
            np.testing.assert_allclose(obs[k][b].numpy(), np.asarray(v), rtol=0, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(float(r[b]), float(r_j), rtol=0, atol=1e-5)
        np.testing.assert_allclose(staged[b].numpy(), np.asarray(staged_j), rtol=0, atol=1e-5)
        assert bool(ok[b]) == bool(ok_j)


def test_step_batch_observations_match_jax(envs, states):
    """One step_batch policy step (the plain unfused path): the observations
    it returns against the JAX env's at the post-step state, the eef force
    and torque zero (a compacting world has no static row layout to read
    them from), '<modality>-state' vectors of the raw values, the reward
    as the JAX env's, done False before the horizon."""
    jenv, penv = envs
    a = torch.zeros(2, penv.action_dim)
    a[:, -1] = 1.0
    s2, obs, r, done, _ = penv.step_batch(states, a)
    assert not bool(done.any())
    for k in ("robot0_eef_force", "robot0_eef_torque"):
        assert obs[k].shape == (2, 3) and not bool(obs[k].any())
    assert obs["robot0_proprio-state"].shape == (2, 45) and obs["object-state"].shape == (2, 40)
    pieces = _jax_pieces(jenv)
    for b in range(2):
        obs_j, r_j, _, _ = pieces(_jax_phys(s2, b))
        for k, v in obs_j.items():
            np.testing.assert_allclose(obs[k][b].numpy(), np.asarray(v), rtol=0, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(float(r[b]), float(r_j), rtol=0, atol=1e-5)
    assert torch.isfinite(torch.cat([v.float().flatten() for v in obs.values()])).all()


def test_pick_place_residual_matches_jax(envs, states):
    """pick_place_residual against the JAX one at the states above and at
    random arm poses, for each object; the PickPlaceCan row steers toward
    object 0 (the milk carton), as the JAX registry's does."""
    from robosuite_tpu.mpc import residuals as jres

    from robosuite_tpu_torch.mpc import residuals

    jenv, penv = envs
    rng = np.random.default_rng(4)
    qpos = np.concatenate([states.physics.qpos.numpy(), states.physics.qpos.numpy()])
    qpos[2:, :7] += 0.2 * rng.standard_normal((2, 7)).astype(np.float32)
    qvel = (0.1 * rng.standard_normal((4, penv.model.nv))).astype(np.float32)
    u = np.zeros((4, 8), np.float32)
    q, qd, ut = torch.as_tensor(qpos), torch.as_tensor(qvel), torch.as_tensor(u)
    jfn = jax.jit(jax.vmap(lambda qq, vv, uu: jnp.stack([
        jres.pick_place_residual(jenv, jenv.model, qq, vv, uu, obj_idx=obj) for obj in range(4)])))
    r_j = np.asarray(jfn(jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(u)))                   # (4, 4 objects, m)
    for obj in range(4):
        r_p = residuals.pick_place_residual(penv, penv.model, q, qd, ut, obj_idx=obj)
        np.testing.assert_allclose(r_p.numpy(), r_j[:, obj], rtol=0, atol=1e-5)
    row = residuals.residual_for(penv)(penv, penv.model, q, qd, ut)
    torch.testing.assert_close(row, residuals.pick_place_residual(penv, penv.model, q, qd, ut, obj_idx=0))
    assert jres.residual_for(jenv).__code__.co_consts.count(0) >= 1  # the JAX row: obj_idx=0
    np.testing.assert_allclose(row.numpy(), r_j[:, 0], rtol=0, atol=1e-5)


def test_placements_inside_bin1(envs):
    """reset_batch's placements: each object's centre inside bin 1 by its
    horizontal radius (ensure_boundary), resting at its bottom offset on
    the bin floor, turned about z by a unit quaternion. (The JAX sampler,
    and so the port's, tests a candidate's offset from bin 1's centre
    against the placed objects' world positions, so it keeps objects apart
    only where the reference position is the origin, as Stack's is; a
    question for the JAX package, ROADMAP.md Queue 3.)"""
    _, penv = envs
    n = 64
    idx, vals, valid = penv._sample_placements(torch.Generator().manual_seed(2), n)
    assert vals.shape == (n, 28) and valid.shape == (n,)
    assert idx == [i for o in penv.objects for i in range(penv.model.jnt_qpos_slice(f"{o.name}_joint0").start,
                                                             penv.model.jnt_qpos_slice(f"{o.name}_joint0").start + 7)]
    half = penv.bin_size[:2] / 2 - 0.05
    for i, o in enumerate(penv.objects):
        v = vals[:, 7 * i:7 * i + 7]
        rel = v[:, :2] - torch.as_tensor(penv.bin1_pos[:2], dtype=torch.float32)
        assert bool((rel.abs() <= torch.as_tensor(half, dtype=torch.float32) - o.horizontal_radius + 1e-6).all())
        torch.testing.assert_close(v[:, 2], torch.full((n,), 0.8 - float(o.bottom_offset[2])), rtol=0, atol=1e-6)
        torch.testing.assert_close(torch.linalg.vector_norm(v[:, 3:], dim=-1), torch.ones(n), rtol=0, atol=1e-6)
        assert not bool(v[:, 4:6].any())
