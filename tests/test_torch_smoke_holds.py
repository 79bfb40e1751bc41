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
