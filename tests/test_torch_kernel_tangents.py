"""The kernels' tangent rules (ops/tangent.py KernelFunction: K1Function,
K2Function, K3Function) on the CPU, with the device code built as host C++
(tests/test_torch_kernels_host.py's harness) as each Function's primal:
the primal outputs are the host kernel's, bit for bit; forward-mode
tangents (torch.autograd.forward_ad duals, and torch.func.jvp) and
reverse-mode gradients are the plain version's at the same primals, to
1e-6 of each output's largest entry (the same computation, order for
order). K1 on Lift; K2 on Lift's contact state; K3 with the OSC law
(Lift) and JOINT_POSITION (Stack), with and without emit_aux. K4 has no
tangent rule: fk_pose refuses a qpos that carries a derivative."""

import functools

import pytest
import torch
from torch.autograd import forward_ad as fwAD

from robosuite_tpu_torch.ops import contact_solve, fk, forward, substep, tables, tangent
from robosuite_tpu_torch.physics import contact as C
from robosuite_tpu_torch.physics import engine
from tests.test_torch_kernels_host import (_image, _jp_inputs, _k1_args, _k1_outputs, _p, contact_state,  # noqa: F401
                                           lib, one_thread, stack_state)


class Counter:
    tangent_passes = 0


def _host_k1(lib, m):
    """K1's device code on the host as a K1Function primal -> OUTPUTS."""
    T = tables.pack(m)
    img = _image(lib, T)

    def primal(q, qd, *leaves):
        B = q.shape[0]
        out = torch.full((forward.out_views(forward.out_shapes(m, B))[1],), float("nan"))
        lib.rs_forward(_p(T), _p(T), _p(img), _p(q), _p(qd), *_k1_args(leaves), _p(out), B, None)
        o = _k1_outputs(m, B, out)
        return tuple(o[n] for n in forward.OUTPUTS)

    return primal


def _host_k2(lib, iters, power_iters, dt):
    def primal(M, JfT, aref, qfrc, qvel, damping, reg3, mu, active):
        qv, f = torch.empty_like(qvel), torch.empty_like(aref)
        lib.rs_contact_solve(*(_p(t) for t in (M, JfT, aref, qfrc, qvel, damping, reg3, mu, active, qv, f)),
                             qvel.shape[0], M.shape[1], active.shape[1], aref.shape[1] - 3 * active.shape[1], iters,
                             power_iters, dt, None)
        return qv, f

    return primal


def _host_k3(lib, env, m, emit_aux):
    T = tables.pack(m, arm=substep.extract_spec(env, m))
    plain = substep.substep_aux_plain if emit_aux else substep.substep_plain

    def primal(*args):
        outs = [torch.empty_like(r) for r in plain(env, m, *args)]
        (lib.rs_substep_aux if emit_aux else lib.rs_substep)(_p(T), _p(T), *(_p(t) for t in (*args, *outs)),
                                                              args[0].shape[0], None)
        return tuple(outs)

    return primal


def _hold(Fn, primal, plain, args, wrt):
    """Fn.apply(primal, plain, ...) at args, tangents on the positions wrt:
    primal outputs = primal's; jvp (duals, and torch.func.jvp) and vjp =
    the plain version's at the same primals, and the tangents finite."""
    gen = torch.Generator().manual_seed(3)
    tans = {i: torch.randn(args[i].shape, generator=gen) for i in wrt}
    want = primal(*args)
    counter = Counter()
    with fwAD.dual_level():
        duals = [fwAD.make_dual(a, tans[i]) if i in tans else a for i, a in enumerate(args)]
        outs = Fn.apply(primal, plain, counter, *duals)
        got = [fwAD.unpack_dual(o) for o in outs]
    assert counter.tangent_passes == 1
    for (p, _), w in zip(got, want):
        assert torch.equal(p, w)

    def plain_of(*xs):
        full = list(args)
        for i, x in zip(wrt, xs):
            full[i] = x
        return plain(*full)

    _, ref = torch.func.jvp(plain_of, tuple(args[i] for i in wrt), tuple(tans[i] for i in wrt))
    _, via_func = torch.func.jvp(lambda *xs: Fn.apply(primal, plain, counter, *[
        dict(zip(wrt, xs)).get(i, a) for i, a in enumerate(args)]), tuple(args[i] for i in wrt),
        tuple(tans[i] for i in wrt))
    for (_, t), r, f in zip(got, ref, via_func):
        assert bool(torch.isfinite(t).all())
        scale = max(1.0, float(r.abs().max()))
        assert float((t - r).abs().max()) <= 1e-6 * scale
        assert float((f - r).abs().max()) <= 1e-6 * scale
    # reverse mode: one cotangent per output
    cots = [torch.randn(w.shape, generator=gen) for w in want]
    leaves = [a.clone().requires_grad_(i in wrt) for i, a in enumerate(args)]
    outs = Fn.apply(primal, plain, counter, *leaves)
    grads = torch.autograd.grad(outs, [leaves[i] for i in wrt], cots, allow_unused=True)
    _, vjp = torch.func.vjp(plain_of, *(args[i] for i in wrt))
    for g, r in zip(grads, vjp(tuple(cots))):
        # the same NaNs where the plain version's own gradient has them (a
        # box-box edge pair's zero cross axis: sqrt'(0), masked in value only)
        assert torch.equal(g.isnan(), r.isnan())
        ok = ~r.isnan()
        if ok.any():
            assert float((g[ok] - r[ok]).abs().max()) <= 1e-6 * max(1.0, float(r[ok].abs().max()))


def test_k1_function_tangents(lib, contact_state):
    env, s = contact_state
    m = env.model
    q, qd = s.physics.qpos.contiguous(), s.physics.qvel.contiguous()
    args = (q, qd, *forward.runtime_leaves(m, q.shape[0]))
    _hold(forward.K1Function, _host_k1(lib, m), functools.partial(forward.plain_outputs, m), args, (0, 1))


def test_k2_function_tangents(lib, contact_state):
    env, s = contact_state
    m, B = env.model, 4
    q, qd = s.physics.qpos, s.physics.qvel
    kin, M, bias = forward.forward_plain(m, q, qd, *forward.runtime_leaves(m, B))
    ctrl = env.robots[0].run_controllers(kin, M, bias, q, qd, s.ctrl, torch.zeros(B, m.nu))
    qfrc, extra = engine.total_smooth_force(m, q, qd, ctrl, M, bias)
    JfT, aref, reg3, mu, act = C.solver_inputs(m, kin, C.narrowphase(m, kin), qd, m.timestep)
    assert int(act.sum(1).max()) >= 4
    args = tuple(t.contiguous() for t in (M, JfT, aref, qfrc, qd, m.dof_damping + extra, reg3, mu, act))
    it = (C.APGD_ITERS, C.POWER_ITERS, m.timestep)
    _hold(contact_solve.K2Function, _host_k2(lib, *it),
          functools.partial(contact_solve.vel_update_plain, iters=it[0], power_iters=it[1], dt=it[2]), args,
          (0, 1, 2, 3, 4))


@pytest.mark.parametrize("law", ["osc", "joint_pos"])
@pytest.mark.parametrize("emit_aux", [False, True], ids=["K3", "K3-aux"])
def test_k3_function_tangents(lib, contact_state, stack_state, law, emit_aux):
    """Tangents on qpos, qvel, the goal, the gains and the gripper ctrl (the
    state, the action and the variable gains all reach them)."""
    if law == "osc":
        env, s = contact_state
        m = env.model.replace(timestep=0.025, solver_iters=10, pair_points_cap=2) if emit_aux else env.model
        q, qd = s.physics.qpos.contiguous(), s.physics.qvel.contiguous()
        leaves = forward.runtime_leaves(m, q.shape[0])
        kin = forward.forward_plain(m, q, qd, *leaves)[0]
        goal, gains = env._fused_goal_fn(env.robots[0], "right", s.ctrl, kin)
        args = (q, qd, *leaves, goal, gains, env.robots[0].gripper_ctrl("right", s.ctrl).contiguous())
    else:
        env, s = stack_state
        m = env.model.replace(timestep=0.025, solver_iters=10) if emit_aux else env.model
        args = _jp_inputs(env, m, s)
    plain = substep.substep_aux_plain if emit_aux else substep.substep_plain
    _hold(substep.K3Function, _host_k3(lib, env, m, emit_aux), functools.partial(plain, env, m), args,
          (0, 1, 6, 7, 8))


def test_fk_pose_refuses_a_derivative(contact_state):
    """K4 has no tangent rule (nor has the JAX kernel): a dual qpos, a qpos
    that requires grad or a torch.func transform's raises; a plain one runs."""
    env, s = contact_state
    m, q = env.model, s.physics.qpos
    with fwAD.dual_level():
        with pytest.raises(ValueError, match="no tangent rule"):
            fk.fk_pose(m, fwAD.make_dual(q, torch.ones_like(q)))
    with pytest.raises(ValueError, match="no tangent rule"):
        fk.fk_pose(m, q.clone().requires_grad_())
    with pytest.raises(ValueError, match="no tangent rule"):
        torch.func.jvp(lambda x: fk.fk_pose(m, x)[0], (q,), (torch.ones_like(q),))
    with torch.no_grad():
        fk.fk_pose(m, q.clone().requires_grad_())   # no graph is recorded: a value
    assert fk.fk_pose(m, q)[0].shape == (q.shape[0], m.nbody, 3)


def test_carries_derivative():
    x = torch.ones(3)
    assert not tangent.carries_derivative(x, None, 1.0)
    assert tangent.carries_derivative(x, x.clone().requires_grad_())
    with torch.no_grad():
        assert not tangent.carries_derivative(x.clone().requires_grad_())
    with fwAD.dual_level():
        assert tangent.carries_derivative(fwAD.make_dual(x, x))
        assert not tangent.carries_derivative(x)
