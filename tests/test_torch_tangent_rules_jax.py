"""The tangent rules of K1 and K2 on the CPU against the JAX package's:
the port's plain versions on forward-mode duals (what K1Function and
K2Function run for tangents on the card) against jax.jvp of the JAX
package's XLA paths (the ones its custom_jvp rules _fp_jvp and _solve_jvp
run), on the same primals and random tangents:

  * K1: engine.forward_products on Lift at random arm poses and
    velocities: the tangents of the poses, M and the bias within 1e-4 of
    each output's largest tangent (float32 chains of 26 bodies, as
    tests/test_torch_mpc.py holds the residual Jacobians);
  * K2: the velocity update at TwoArmPegInHole's contact state (nv 14,
    117 static rows; ab_kernels.peg_contact_state), on the scenarios with
    an active row, tangents on M, JfT, aref, the smooth force and qvel:
    qvel' and f within 1e-3 of their largest tangent (30 APGD iterations
    in float32 amplify the rounding of the two frameworks' Choleskys, as
    the primal's 1e-4 in tests/test_torch_twoarm_step.py does).

The JAX side's jvp of the power iteration is NaN on a scenario with no
active row (the derivative of jnp.linalg.norm at 0), where the port's is
0; such scenarios are left out. The whole planning dynamics' Jacobians
against jax.jacfwd are held in tests/test_torch_mpc_jacfwd.py."""

import numpy as np
import torch
from torch.autograd import forward_ad as fwAD

import jax
import jax.numpy as jnp

import robosuite_tpu_torch
from robosuite_tpu_torch import ab_kernels
from robosuite_tpu_torch.ops import contact_solve, forward
from robosuite_tpu_torch.physics import contact as C
from robosuite_tpu_torch.physics import engine
from tests.test_torch_door import one_thread  # noqa: F401  (an autouse fixture: one torch thread)


def _tangents_close(p, j, rel):
    j = np.asarray(j)
    np.testing.assert_allclose(p.numpy(), j, rtol=0, atol=rel * max(1e-6, float(np.abs(j).max())))


def test_k1_rule_matches_jax_forward_products():
    import robosuite_tpu
    from robosuite_tpu.physics import engine as JE
    from robosuite_tpu.physics.state import State as JState

    jenv = robosuite_tpu.make("Lift", robots="Panda", cube_size=[0.021] * 3)
    penv = robosuite_tpu_torch.make("Lift", robots="Panda", cube_size=[0.021] * 3, device="cpu")
    m = penv.model
    rng = np.random.default_rng(21)
    q = np.tile(m.qpos0.numpy(), (3, 1))
    q[:, :7] += rng.uniform(-0.5, 0.5, (3, 7))
    q = q.astype(np.float32)
    qd = rng.normal(size=(3, m.nv)).astype(np.float32)
    tq, tqd = (rng.normal(size=x.shape).astype(np.float32) for x in (q, qd))
    with fwAD.dual_level():
        kin, M, bias = forward.forward_products(m, fwAD.make_dual(torch.as_tensor(q), torch.as_tensor(tq)),
                                                fwAD.make_dual(torch.as_tensor(qd), torch.as_tensor(tqd)))
        got = {n: fwAD.unpack_dual(v).tangent for n, v in dict(kin.__dict__, M=M, bias=bias).items()
               if n in forward.OUTPUTS}

    def fp(q1, qd1):
        kin_j, M_j, b_j = JE.forward_products(jenv.model, JState(qpos=q1, qvel=qd1, time=jnp.zeros(())))
        return dict({n: getattr(kin_j, n) for n in forward.OUTPUTS if n not in ("M", "bias")}, M=M_j, bias=b_j)

    _, want = jax.jit(jax.vmap(lambda a, b, ta, tb: jax.jvp(fp, (a, b), (ta, tb))))(q, qd, tq, tqd)
    for n in forward.OUTPUTS:
        _tangents_close(got[n], want[n], 1e-4)


def test_k2_rule_matches_jax_vel_update():
    from robosuite_tpu.ops import pallas_contact as JPC

    env = robosuite_tpu_torch.make("TwoArmPegInHole", robots=("Panda", "Panda"), env_configuration="opposed",
                                   device="cpu")
    s, _ = env.reset_batch(4, torch.Generator().manual_seed(11))
    s = ab_kernels.peg_contact_state(env, s)
    m, B = env.model, 4
    q, qd = s.physics.qpos, s.physics.qvel
    kin, M, bias = forward.forward_products(m, q, qd)
    ctrl = env.run_controllers(kin, M, bias, q, qd, s.ctrl)
    qfrc, extra = engine.total_smooth_force(m, q, qd, ctrl, M, bias)
    JfT, aref, reg3, mu, act = C.solver_inputs(m, kin, C.narrowphase(m, kin), qd, m.timestep)
    keep = act.sum(1) > 0
    assert int(keep.sum()) >= 2 and act.shape[1] == 117
    args = [t[keep].contiguous() for t in (M, JfT, aref, qfrc, qd, m.dof_damping + extra, reg3, mu, act)]
    gen = torch.Generator().manual_seed(5)
    tans = [torch.randn(a.shape, generator=gen) * (0.1 * a.abs().max()) for a in args[:5]]
    it = (C.APGD_ITERS, C.POWER_ITERS, m.timestep)
    with fwAD.dual_level():
        outs = contact_solve.vel_update(*[fwAD.make_dual(a, t) for a, t in zip(args[:5], tans)], *args[5:], *it)
        got = [fwAD.unpack_dual(o).tangent for o in outs]
    K = act.shape[1]

    def solve(*a):
        return JPC._vel_update_xla(*a, K, 0, it[0], it[1], it[2])

    def jvp_one(*a):
        return jax.jvp(lambda *x: solve(*x, *a[5:9]), tuple(a[:5]), tuple(a[9:]))[1]

    want = jax.jit(jax.vmap(jvp_one))(*(a.numpy() for a in args), *(t.numpy() for t in tans))
    for g, w in zip(got, want):
        assert np.isfinite(np.asarray(w)).all()
        _tangents_close(g, w, 1e-3)
