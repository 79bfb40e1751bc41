"""The port's OSC in every setting the JAX package's takes besides OSC_POSE
with delta input in the base frame: OSC_POSITION (control_ori=False, the
orientation goal frozen at the eef's), absolute input, the world reference
frame, goal_update_mode "desired" and a per-scenario `wrt_origin`, and
linear goal interpolation, against the JAX OSC on the same arm views at
Lift-Panda poses (forward products of both packages at the same qpos and
qvel). set_goal runs twice, so the interpolation ramps from one goal to
the next; desired_world_pose and run at every substep of the ramp and one
past it. Bounds, the port's OSC tolerance (tests/test_torch_wipe.py):
goals and poses 1e-5, torques 1e-5 of their largest (the port's
operational-space inverses run in float64, ROADMAP Queue 3)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robosuite_tpu_torch.controllers import factory
from robosuite_tpu_torch.controllers.parts import osc
from robosuite_tpu_torch.ops import forward
from tests.test_torch_door import one_thread  # noqa: F401  (an autouse fixture: one torch thread)

B = 4
CONFIGS = {
    "OSC_POSITION": ("OSC_POSITION", {}),
    "OSC_POSITION absolute": ("OSC_POSITION", dict(input_type="absolute")),
    "absolute": ("OSC_POSE", dict(input_type="absolute")),
    "world": ("OSC_POSE", dict(input_ref_frame="world")),
    "absolute world": ("OSC_POSE", dict(input_type="absolute", input_ref_frame="world")),
    "linear": ("OSC_POSE", dict(interpolation="linear")),
    "linear world ramp 0.4": ("OSC_POSE", dict(interpolation="linear", input_ref_frame="world", ramp_ratio=0.4)),
    "OSC_POSITION linear": ("OSC_POSITION", dict(interpolation="linear")),
}


@pytest.fixture(scope="module")
def views():
    """(the JAX package's batched view, the port's): Lift-Panda reset poses
    moved by 0.2 rad, with arm velocities, through each package's forward
    products."""
    import robosuite_tpu
    import robosuite_tpu_torch
    from robosuite_tpu.physics import engine as JE
    from robosuite_tpu.physics.state import State as JState

    jenv = robosuite_tpu.make("Lift", robots="Panda", cube_size=[0.021] * 3)
    penv = robosuite_tpu_torch.make("Lift", robots="Panda", cube_size=[0.021] * 3, device="cpu")
    s, _ = penv.reset_batch(B, torch.Generator().manual_seed(4))
    rng = np.random.default_rng(5)
    qpos = s.physics.qpos.numpy().copy()
    qpos[:, :7] += (0.2 * rng.standard_normal((B, 7))).astype(np.float32)
    qvel = np.zeros((B, penv.model.nv), np.float32)
    qvel[:, :7] = (0.3 * rng.standard_normal((B, 7))).astype(np.float32)
    q, v = torch.as_tensor(qpos), torch.as_tensor(qvel)
    kin, M, bias = forward.forward_products(penv.model, q, v)

    def jax_view(q, v):
        kin, M, bias = JE.forward_products(jenv.model, JState(qpos=q, qvel=v, time=jnp.asarray(0.0)))
        return jenv.robots[0].arm_view(kin, M, bias, q, v, "right")

    jview = jax.jit(jax.vmap(jax_view))(jnp.asarray(qpos), jnp.asarray(qvel))
    return jview, penv.robots[0].arm_view(kin, M, bias, q, v, "right")


def _actions(cfg, pview, rng):
    """Two actions: deltas in [-1.2, 1.2], or absolute goals near the eef
    (its position in the frame, plus up to 5 cm; an axis-angle within 0.3
    rad of the frame's identity)."""
    acts = []
    for _ in range(2):
        a = rng.uniform(-1.2, 1.2, (B, cfg.control_dim)).astype(np.float32)
        if cfg.input_type == "absolute":
            pos, _ = osc._eef_pose(cfg, pview)
            a[:, :3] = pos.numpy() + rng.uniform(-0.05, 0.05, (B, 3))
            if cfg.control_ori:
                a[:, 3:6] = rng.uniform(-0.3, 0.3, (B, 3))
        acts.append(a)
    return acts


@pytest.mark.parametrize("name", list(CONFIGS))
def test_osc_setting_matches_jax(views, name):
    from robosuite_tpu.controllers import factory as jfactory
    from robosuite_tpu.controllers.parts import osc as josc

    jview, pview = views
    t, kw = CONFIGS[name]
    cfg = factory.arm_controller_config(t, **kw)
    jcfg = jfactory.arm_controller_config(t, **kw)
    assert (cfg.control_dim, cfg.base_dim, cfg.interp_steps) == (jcfg.control_dim, jcfg.base_dim, jcfg.interp_steps)
    # every substep of the ramp and one past it (without interpolation the
    # substep is not read: one)
    subs = [None] + list(range(cfg.interp_steps + 1 if cfg.interpolation else 1))
    a1, a2 = _actions(cfg, pview, np.random.default_rng(len(name)))

    def jax_law(view, a1, a2):
        st = josc.set_goal(jcfg, josc.set_goal(jcfg, josc.init_state(jcfg, view), view, a1), view, a2)
        poses = [josc.desired_world_pose(jcfg, st, view.origin_pos, view.origin_ori, k) for k in subs]
        taus = [josc.run(jcfg, st, view, substep=k) for k in subs]
        return st.goal_pos, st.goal_ori, st.start_pos, st.start_ori, poses, taus

    want = jax.jit(jax.vmap(jax_law))(jview, jnp.asarray(a1), jnp.asarray(a2))
    st = osc.set_goal(cfg, osc.set_goal(cfg, osc.init_state(cfg, pview), pview, torch.as_tensor(a1)), pview,
                      torch.as_tensor(a2))
    poses = [osc.desired_world_pose(cfg, st, pview.origin_pos, pview.origin_ori, k) for k in subs]
    taus = [osc.run(cfg, st, pview, substep=k) for k in subs]
    for got, w, label in ((st.goal_pos, want[0], "goal_pos"), (st.goal_ori, want[1], "goal_ori"),
                          (st.start_pos, want[2], "start_pos"), (st.start_ori, want[3], "start_ori")):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=0, atol=1e-5, err_msg=label)
    for k, (p, r), (pj, rj) in zip(subs, poses, want[4]):
        np.testing.assert_allclose(p.numpy(), np.asarray(pj), rtol=0, atol=1e-5, err_msg=f"desired pos, substep {k}")
        np.testing.assert_allclose(r.numpy(), np.asarray(rj), rtol=0, atol=1e-5, err_msg=f"desired ori, substep {k}")
    for k, tau, tj in zip(subs, taus, want[5]):
        tj = np.asarray(tj)
        np.testing.assert_allclose(tau.numpy(), tj, rtol=0, atol=1e-5 * max(1.0, float(np.abs(tj).max())),
                                   err_msg=f"torques, substep {k}")
    if not cfg.control_ori:  # the orientation goal holds the eef's orientation in the frame
        np.testing.assert_allclose(st.goal_ori.numpy(), osc._eef_pose(cfg, pview)[1].numpy(), rtol=0, atol=1e-6)
    if cfg.interpolation == "linear":  # the ramp moves, and ends at the goal
        assert float((poses[1][0] - poses[-1][0]).abs().max()) > 1e-3
        np.testing.assert_allclose(poses[-1][0].numpy(), poses[0][0].numpy(), rtol=0, atol=1e-5)


def test_goal_update_modes_match_jax(views):
    """goal_update_mode "desired" (the delta on the previous goal) and a
    per-scenario wrt_origin (the JAX traced-bool form, here (B,) bools)."""
    from robosuite_tpu.controllers import factory as jfactory
    from robosuite_tpu.controllers.parts import osc as josc

    jview, pview = views
    cfg, jcfg = factory.arm_controller_config("OSC_POSE"), jfactory.arm_controller_config("OSC_POSE")
    rng = np.random.default_rng(9)
    a1, a2 = (rng.uniform(-1, 1, (B, 6)).astype(np.float32) for _ in range(2))
    flags = np.array([True, False, True, False])

    def jax_law(view, a1, a2, flag):
        st = josc.set_goal(jcfg, josc.init_state(jcfg, view), view, a1)
        d = josc.set_goal(jcfg, st, view, a2, goal_update_mode="desired")
        w = josc.set_goal(jcfg, st, view, a2, wrt_origin=flag)
        return d.goal_pos, d.goal_ori, w.goal_pos, w.goal_ori

    want = jax.jit(jax.vmap(jax_law))(jview, *(jnp.asarray(x) for x in (a1, a2, flags)))
    st = osc.set_goal(cfg, osc.init_state(cfg, pview), pview, torch.as_tensor(a1))
    d = osc.set_goal(cfg, st, pview, torch.as_tensor(a2), goal_update_mode="desired")
    w = osc.set_goal(cfg, st, pview, torch.as_tensor(a2), wrt_origin=torch.as_tensor(flags))
    for got, wj in zip((d.goal_pos, d.goal_ori, w.goal_pos, w.goal_ori), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(wj), rtol=0, atol=1e-5)
    torch.testing.assert_close(w.goal_pos[0], d.goal_pos[0])
    assert float((w.goal_pos[1] - d.goal_pos[1]).abs().max()) > 1e-4
