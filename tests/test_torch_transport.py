"""TwoArmTransport with two Pandas (OSC_POSE, "opposed"): the port on the
CPU (its plain path) against the JAX package on the same inputs. The
largest world of the JAX package: nq 39, nv 36 (K2's dof maximum), 53
bodies (past K1's earlier body maximum of 48), 170 geoms, 23 sites, 250
pairs, 905 candidate rows compacted into 96 slots.

  * the world: every compiled leaf 1e-7, the static structure exactly, the
    row layout and compaction, the action width; the bins, the lid and the
    payload against the JAX package's objects; MultiTableArena's tables and
    their top sites;
  * the fused substep's gate refuses it for its two robots; K1's table
    takes it;
  * the fixed initial poses: the payload in the start bin, the lid over it
    and the trash on table 0 in every scenario whatever the generator, a
    JAX reset injected into the port giving the JAX reset's observations
    (1e-5);
  * the observations, the staged reward and success (1e-5) at the contact
    state (ab_kernels.transport_contact_state: robot0's pads on the lid's
    handle), and with the payload and the trash moved into the target and
    trash bins in both packages' kin (the success branch), and with the
    payload grasped (pair distances injected) and the lid lifted off;
  * step_batch against rollout_batch from the same states, bit for bit.

One substep, one policy step and one MPPI solve are held in
tests/test_torch_transport_step.py.
"""

import numpy as np
import torch

from robosuite_tpu_torch import ab_kernels
from robosuite_tpu_torch.ops import substep, tables
from robosuite_tpu_torch.physics import kinematics
from robosuite_tpu_torch.physics.state import KinData
from tests.test_torch_handover_toolhang import hold_jax_reset, hold_objects, hold_pieces, hold_world
from tests.test_torch_last_envs_step import one_thread  # noqa: F401

KW = dict(robots=("Panda", "Panda"), reward_shaping=True)
_ENVS = {}


def envs():
    """(the JAX env, the port's CPU env), made once."""
    if not _ENVS:
        import robosuite_tpu
        import robosuite_tpu_torch

        _ENVS["w"] = (robosuite_tpu.make("TwoArmTransport", **KW),
                      robosuite_tpu_torch.make("TwoArmTransport", device="cpu", **KW))
    return _ENVS["w"]


def test_world_matches_jax():
    jenv, penv = envs()
    hold_world(jenv, penv, (39, 36, 53, 170, 23, 18, 250, 905))
    hold_objects([(getattr(penv, n), getattr(jenv, n)) for n in ("payload", "start_bin", "target_bin", "trash_bin",
                                                                  "lid")])
    assert penv.trash.root_body == jenv.trash.root_body
    pm = penv.model
    assert [pm.body_name2id(f"table{i}") for i in (0, 1)] == [jenv.model.body_name2id(f"table{i}") for i in (0, 1)]
    for i, off in enumerate(penv.table_offsets):
        top = pm.site_pos[pm.site_name2id(f"table{i}_top")] + pm.body_pos[pm.body_name2id(f"table{i}")]
        np.testing.assert_allclose(top.numpy(), off, rtol=0, atol=1e-6)
    for f in ("payload_body", "trash_body", "lid_body", "eef_sites"):
        assert getattr(penv, f) == getattr(jenv, f), f
    assert [tuple(p) for p in penv._payload_grasp] == [
        tuple(jenv._rows_to_pairs(r) for r in rows) for rows in jenv._payload_grasp]
    # the bins are fixed in the world: no joint, their bodies where _load_model puts them
    for b in (penv.start_bin, penv.target_bin, penv.trash_bin):
        assert not b.joints and not any(n.startswith(b.name) for n in pm.jnt_names)


def test_fused_gate_refuses_two_robots_and_k1_takes_the_world():
    import pytest

    from robosuite_tpu.ops import pallas_substep as JPS

    jenv, penv = envs()
    pm = penv.model
    with pytest.raises(substep.UnsupportedFused, match="one fixed-base robot"):
        substep.extract_spec(penv, pm)
    with pytest.raises(JPS.UnsupportedFused):
        JPS.extract_spec(jenv, jenv.model)
    assert penv._fused_for(pm) is None and tables.check_model(pm, contacts=False) == 0


def test_fixed_initial_poses_and_jax_reset_injected():
    """The payload 5 cm above the start bin's centre, the lid 12 cm above
    it and the trash on table 0, upright, in every scenario and for any
    generator (nothing is drawn); a JAX reset injected into the port: the
    same observations and body poses (1e-5)."""
    jenv, penv = envs()
    idx, vals = penv._sample_placements(torch.Generator().manual_seed(1), 3)
    idx2, vals2 = penv._sample_placements(torch.Generator().manual_seed(2), 3)
    assert idx == idx2 and torch.equal(vals, vals2) and vals.shape == (3, 21)
    start = np.array([-0.35, -0.15, 0.86])
    want = np.concatenate([start + [0, 0, 0.05], [1, 0, 0, 0], [-0.35, 0.0, 0.87], [1, 0, 0, 0],
                           start + [0, 0, 0.12], [1, 0, 0, 0]])
    np.testing.assert_allclose(vals[0].numpy(), want, rtol=0, atol=1e-6)
    m = penv.model
    assert idx == [i for n in ("payload", "trash", "lid") for i in range(*m.jnt_qpos_slice(f"{n}_joint0").indices(m.nq))]
    ps = hold_jax_reset(jenv, penv, 7, 2)
    np.testing.assert_allclose(ps.physics.qpos[:, idx].numpy(), vals[:2].numpy(), rtol=0, atol=1e-6)


def test_reward_observations_success_match_jax():
    """At robot0's grasp of the lid's handle (transport_contact_state, 2
    scenarios): observations, the staged reward and success against the
    JAX env's; then, injected into both kins, the payload grasped by
    robot1 (its pads' pair distances) with the lid lifted off the start
    bin, and the payload and the trash set in the target and trash bins
    (the success branch: 1)."""
    jenv, penv = envs()
    s, _ = penv.reset_batch(2, torch.Generator().manual_seed(3))
    s = ab_kernels.transport_contact_state(penv, s)
    kin = kinematics.fk(penv.model, s.physics.qpos)
    lid = penv.grasp_pairs("right", penv.lid.handle_geoms, robot_idx=0)
    assert bool(penv.check_grasp(kin, *lid).all())
    r, ok = hold_pieces(jenv, penv, s.physics, kin)
    assert not bool(ok.any()) and 0.1 < float(r.min()) and float(r.max()) < 0.3
    pd = torch.ones(2, penv.model.npair)
    for pairs in penv._payload_grasp[1]:
        pd[:, pairs] = -1e-3
    staged = KinData(**{f: v.clone() for f, v in kin.__dict__.items() if v is not None and f != "pair_dist"},
                     pair_dist=pd)
    staged.xpos[:, penv.lid_body, :2] += torch.tensor([0.0, 0.3])
    r2, ok = hold_pieces(jenv, penv, s.physics, staged)
    assert not bool(ok.any()) and bool((r2 > r + 0.29).all())  # the lid's 0.1 and the grasp's 0.2
    staged.xpos[:, penv.payload_body] = torch.as_tensor(penv.target_bin_pos, dtype=torch.float32) + 0.02
    staged.xpos[:, penv.trash_body] = torch.as_tensor(penv.trash_bin_pos, dtype=torch.float32) - 0.02
    r3, ok = hold_pieces(jenv, penv, s.physics, staged)
    assert bool(ok.all()) and torch.equal(r3, torch.ones(2))


def test_step_batch_matches_rollout_batch():
    """Two step_batch policy steps from a reset against rollout_batch from
    the same states: physics, goals and rewards bit for bit; every robot's
    eef wrench zero (a compacting world)."""
    _, penv = envs()
    s, _ = penv.reset_batch(2, torch.Generator().manual_seed(4))
    a = torch.clamp(0.5 * torch.randn(2, penv.action_dim, generator=torch.Generator().manual_seed(5)), -1, 1)
    for _ in range(2):
        s2, obs, r, done, _ = penv.step_batch(s, a)
        s3, r3 = penv.rollout_batch(s, a)
        for x, y in ((s2.physics.qpos, s3.physics.qpos), (s2.physics.qvel, s3.physics.qvel), (r, r3)):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
        for c2, c3 in zip(s2.ctrl, s3.ctrl):
            torch.testing.assert_close(c2.arm["right"].goal_pos, c3.arm["right"].goal_pos, rtol=0, atol=0)
        s = s2
    assert not bool(done.any())
    for i in range(2):
        assert not bool(obs[f"robot{i}_eef_force"].any()) and obs[f"robot{i}_proprio-state"].shape[0] == 2
