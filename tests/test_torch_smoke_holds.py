"""chip_smoke.py's pair-distance hold (hold_pair_dist) on the CPU: a
mismatch with the plain version beyond the tolerance passes only with a
float64 witness. Here the witness of an ill-conditioned edge separation:
the kernel's value within the tolerance of the float64 distance at its own
qpos, the float64 distances at both versions' qpos within it of each
other. The distances are the plain version's at Lift reset states, one
(scenario, box-box pair) moved by hand."""

import os
import sys

import pytest
import torch

import robosuite_tpu_torch as R
from robosuite_tpu_torch.physics import contact as C
from robosuite_tpu_torch.physics import kinematics

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

TOL = 2e-5


@pytest.fixture(scope="module")
def lift_distances():
    """(planning model, qpos, float32 plain distances, float64 distances)."""
    env = R.make("Lift", robots="Panda", reward_shaping=True, device="cpu")
    states, _ = env.reset_batch(4, torch.Generator().manual_seed(0))
    plan = env.model.replace(timestep=0.025, solver_iters=10, pair_points_cap=2)
    q = states.physics.qpos
    m64 = plan.replace().double()
    return (plan, q, C.pair_min_dists(plan, kinematics.fk(plan, q)),
            C.pair_min_dists(m64, kinematics.fk(m64, q.double())))


def _box_box_pair(model):
    from robosuite_tpu_torch.models import spec as S

    return next(k for k in range(model.npair)
                if model.geom_type[model.pair_geom1[k]] == S.BOX and model.geom_type[model.pair_geom2[k]] == S.BOX)


@pytest.mark.parametrize("kernel_off, witnessed", [(-1.5e-5, True), (4e-5, False)],
                         ids=["within-float64", "off-float64"])
def test_pair_dist_float64_witness(lift_distances, monkeypatch, kernel_off, witnessed):
    """The plain value 1e-5 above float64 and the kernel's `kernel_off` from
    it: 2.5e-5 apart, within the tolerance of float64, passes with the
    witness; 3e-5 apart, 4e-5 from float64, fails."""
    plan, q, pd, d64 = lift_distances
    monkeypatch.setattr(chip_smoke, "FAILED", [])
    k = _box_box_pair(plan)
    pk, pp = pd.clone(), pd.clone()
    pk[1, k] = float(d64[1, k]) + kernel_off
    pp[1, k] = float(d64[1, k]) + 1e-5
    assert float((pk - pp).abs().max()) > TOL
    err = chip_smoke.hold_pair_dist("test", plan, pk, pp, q, q, tol=TOL)
    assert (err <= TOL) == witnessed
    assert (chip_smoke.FAILED == []) == witnessed


# a TwoArmHandover reset the card drew (chip_smoke.py's seed): the hammer's
# head lands flat on the table in the 24th and 25th substeps of the first
# policy step, four box-box rows at one depth under the light hammer
HAMMER_RESET = [-0.010895534418523312, 0.22588349878787994, -0.012877938337624073, -2.6502811908721924,
                0.003708077361807227, 2.971616506576538, 0.8001559972763062, 0.020833000540733337,
                -0.020833000540733337, 0.01439004298299551, 0.1892746239900589, 0.0186283141374588,
                -2.5864405632019043, -0.0016754964599385858, 2.9108402729034424, 0.7895723581314087,
                0.020833000540733337, -0.020833000540733337, 0.03430134803056717, -0.031026994809508324,
                0.8399999737739563, -0.3828984797000885, 0.0, 0.0, 0.923790454864502]


@pytest.fixture(scope="module")
def landing_operands():
    """K2's float32 operands at the 25th substep of that policy step (the
    plain path, grippers opening), and the plain solve's (qvel, f)."""
    from robosuite_tpu_torch.ops import contact_solve
    from robosuite_tpu_torch.physics import engine

    env = R.make("TwoArmHandover", robots=("Panda", "Panda"), reward_shaping=True, device="cpu")
    m = env.model
    s = env.state_from_flattened(torch.cat([torch.zeros(1, 1), torch.tensor([HAMMER_RESET]), torch.zeros(1, m.nv)], 1))
    a = torch.zeros(1, env.action_dim)
    for r in env._split_robot_actions(a):
        r[:, -1] = -1.0
    kin, M, bias = engine.forward_products(m, s.physics.qpos, s.physics.qvel)
    ctrl = env._set_goals(kin, M, bias, s.physics.qpos, s.physics.qvel, s.ctrl, a)
    ph = s.physics
    for j in range(25):
        q, qd = ph.qpos, ph.qvel
        kin, M, bias = engine.forward_products(m, q, qd)
        qfrc, extra = engine.total_smooth_force(m, q, qd, env.run_controllers(kin, M, bias, q, qd, ctrl), M, bias)
        JfT, aref, reg3, mu, act = C.solver_inputs(m, kin, C.narrowphase(m, kin), qd, m.timestep)
        args = (M.contiguous(), JfT, aref.contiguous(), qfrc.contiguous(), qd.contiguous(),
                (m.dof_damping + extra).contiguous(), reg3.contiguous(), mu, act.contiguous(),
                *C.solver_iterations(m), m.timestep)
        out_p = contact_solve.vel_update_plain(*args)
        ph = engine.State(qpos=engine.integrate_qpos(m, q, out_p[0], m.timestep), qvel=out_p[0], time=ph.time)
    assert int(act.sum()) == 4
    return args, out_p


@pytest.mark.parametrize("kernel, witnessed", [(1.0, True), (-8.0, True), (-10.0, False)],
                         ids=["at-float64", "9x-off", "11x-off"])
def test_solve_conditioning_witness(landing_operands, kernel, witnessed):
    """solve_conditioning_witness at the hammer's flat landing, where the
    float32 plain solve lies beyond K2's 1e-4 from the float64 solve of its
    own operands (1.5e-3 relative): a kernel result at the float64 solve,
    or 9 times the plain one's distance from float64 (on the plain one's
    side, beyond it), is witnessed; 11 times (past ILL_FACTOR 10) is not."""
    from robosuite_tpu_torch.ops import contact_solve

    args, (qv_p, f_p) = landing_operands
    q64, f64 = contact_solve.vel_update_plain(*[a.double() if torch.is_tensor(a) else a for a in args])
    own = float((qv_p.double() - q64).abs().max())
    assert own > 1e-3 * max(1.0, float(qv_p.abs().max()))  # the float32 solve's own error: past K2's 1e-4
    k = kernel  # the kernel at plain + k (float64 - plain): |1 - k| times the plain one's distance from float64
    out_k = ((qv_p.double() + k * (q64 - qv_p.double())).float(), (f_p.double() + k * (f64 - f_p.double())).float())
    scales = (max(1.0, float(qv_p.abs().max())), max(1.0, float(f_p.abs().max())))
    why = chip_smoke.solve_conditioning_witness(args, [0], out_k, (qv_p, f_p), scales)[0]
    assert (why is not None) == witnessed
