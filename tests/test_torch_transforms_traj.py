"""The port's rotation and pose helpers (utils/transforms.py) and its goal
interpolator (utils/traj_utils.py) against the JAX package's on the same
numpy-seeded inputs: every function of the JAX transforms module the port
lacked before goal interpolation and IK came (batched here, each scenario
through the JAX function), and the interpolator in all three
`ori_interpolate` modes over a whole ramp. Bound: 1e-6 (float32 rounding
of a few trigonometric and product terms of order 1)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from robosuite_tpu_torch.utils import traj_utils as TU
from robosuite_tpu_torch.utils import transforms as T
from tests.test_torch_door import one_thread  # noqa: F401  (an autouse fixture: one torch thread)

B = 8
TOL = 1e-6


def _quats(rng, n=B):
    q = rng.standard_normal((n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _inputs(rng):
    """name -> its arguments (numpy, batch on dim 0), with the branches'
    edge cases in some rows."""
    from robosuite_tpu.utils import transforms as JT

    q0, q1 = _quats(rng), _quats(rng)
    q1[0] = q0[0]                                  # identical: slerp's linear branch
    q1[1] = -q0[1]                                 # opposite: the shortest path flips
    mats = np.array(JT.quat2mat(jnp.asarray(_quats(rng))))
    mats[2] = np.diag([1.0, -1.0, -1.0])           # a pivot other than w (Shepperd)
    euler = rng.uniform(-np.pi, np.pi, (B, 3)).astype(np.float32)
    euler[3, 1] = np.pi / 2                        # gimbal lock: mat2euler's cy = 0 branch
    aa = rng.uniform(-2.0, 2.0, (B, 3)).astype(np.float32)
    aa[4] = 0.0                                    # zero rotation: the Taylor branch
    pos = rng.standard_normal((B, 3)).astype(np.float32)
    pose = np.array(JT.make_pose(jnp.asarray(pos), jnp.asarray(mats)))
    frac = rng.uniform(0.0, 1.0, B).astype(np.float32)
    return dict(
        quat_multiply=(q0, q1), quat_conjugate=(q0,), quat_inverse=(2.0 * q0,), quat_distance=(q0, q1),
        quat_slerp=(q0, q1, frac), quat2axisangle=(q0 * np.sign(q0[:, 3:4]),), euler2mat=(euler,),
        mat2euler=(mats,), pose2mat=((pos, q0),), mat2pose=(pose,), make_pose=(pos, mats), pose_inv=(pose,),
        pose_in_A_to_pose_in_B=(pose, np.array(JT.make_pose(jnp.asarray(pos[::-1].copy()),
                                                                jnp.asarray(mats[::-1].copy())))),
        rotation_matrix=(rng.uniform(-3.0, 3.0, B).astype(np.float32), rng.standard_normal((B, 3)).astype(np.float32)),
        skew=(pos,), axisangle2quat_wxyz=(aa,), mat2quat_wxyz=(mats,), quat_conj_wxyz=(q0,),
    )


def _tree(x, fn):
    if isinstance(x, tuple):
        return tuple(_tree(v, fn) for v in x)
    return fn(x)


NAMES = ("quat_multiply", "quat_conjugate", "quat_inverse", "quat_distance", "quat_slerp", "quat2axisangle",
         "euler2mat", "mat2euler", "pose2mat", "mat2pose", "make_pose", "pose_inv", "pose_in_A_to_pose_in_B",
         "rotation_matrix", "skew", "axisangle2quat_wxyz", "mat2quat_wxyz", "quat_conj_wxyz")


def test_inputs_cover_every_function():
    assert sorted(_inputs(np.random.default_rng(0))) == sorted(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_transform_matches_jax(name):
    """Each scenario through the JAX function against the batched port."""
    from robosuite_tpu.utils import transforms as JT

    args = _inputs(np.random.default_rng(0))[name]
    got = getattr(T, name)(*_tree(args, torch.as_tensor))
    got = got if isinstance(got, tuple) else (got,)
    for b in range(B):
        want = getattr(JT, name)(*_tree(args, lambda x: jnp.asarray(x[b])))
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(w), rtol=0, atol=TOL, err_msg=f"{name}[{b}]")


def test_slerp_scalar_fraction_and_rotation_matrix_shapes():
    """quat_slerp takes a Python number as the JAX one does (the OSC
    interpolation's fraction); rotation_matrix takes one angle and axis."""
    from robosuite_tpu.utils import transforms as JT

    rng = np.random.default_rng(1)
    q0, q1 = _quats(rng), _quats(rng)
    got = T.quat_slerp(torch.as_tensor(q0), torch.as_tensor(q1), 0.4).numpy()
    np.testing.assert_allclose(got, np.asarray(JT.quat_slerp(jnp.asarray(q0), jnp.asarray(q1), 0.4)), rtol=0,
                               atol=TOL)
    r = T.rotation_matrix(0.7, torch.tensor([0.0, 1.0, 1.0]))
    assert r.shape == (3, 3)
    np.testing.assert_allclose(r.numpy(), np.asarray(JT.rotation_matrix(0.7, [0.0, 1.0, 1.0])), rtol=0, atol=TOL)


@pytest.mark.parametrize("mode", [None, "euler", "quat"])
def test_linear_interpolator_matches_jax(mode):
    """set_goal twice (the start becomes the first goal), then
    get_interpolated_goal over the ramp and two steps past its end; each
    scenario through the JAX interpolator. The config's total_steps as
    the JAX one's (ramp_ratio 0.2 at 500 / 20 Hz: 5)."""
    from robosuite_tpu.utils import traj_utils as JTU

    rng = np.random.default_rng({None: 2, "euler": 3, "quat": 4}[mode])
    ndim = 4 if mode == "quat" else 3
    kw = dict(ndim=ndim, ori_interpolate=mode)
    cfg, jcfg = TU.LinearInterpolatorConfig(**kw), JTU.LinearInterpolatorConfig(**kw)
    assert cfg.total_steps == jcfg.total_steps == 5

    def goal():
        if mode == "quat":
            return _quats(rng)
        return rng.uniform(-1.5, 1.5, (B, 3)).astype(np.float32)

    g1, g2 = goal(), goal()
    st = TU.set_goal(cfg, TU.set_goal(cfg, TU.init_state(cfg, B), torch.as_tensor(g1)), torch.as_tensor(g2))
    jst = [JTU.set_goal(jcfg, JTU.set_goal(jcfg, JTU.init_state(jcfg), jnp.asarray(g1[b])), jnp.asarray(g2[b]))
           for b in range(B)]
    for _ in range(cfg.total_steps + 2):
        out, st = TU.get_interpolated_goal(cfg, st)
        for b in range(B):
            want, jst[b] = JTU.get_interpolated_goal(jcfg, jst[b])
            np.testing.assert_allclose(out[b].numpy(), np.asarray(want), rtol=0, atol=TOL)
        assert int(st.step[0]) == int(jst[0].step)
