"""K1 and K2 on the wheeled and legged worlds of Lift, compiled for the CPU
(the host build of tests/test_torch_kernels_tendons.py's harness), against
their plain versions:

  * K1 against forward_plain (poses 2e-5; M 1e-5 and bias 1e-4 of their
    largest; chip_smoke.py's tolerances), 4 scenarios a block, at each of
    PandaOmron, Tiago (60 bodies, 31 joints: past the earlier RS_MAXB 56
    and RS_MAXJ 24), SpotWithArm (two free joints: Spot's root, then the
    cube's) and SpotWithArmFloating, at states two policy steps after a
    reset with seeded velocities on every dof;
  * K2 against vel_update_plain (qvel and f 1e-4 of max(1, their
    largest)) on the plain path's operands there, over one lane and a
    32-thread team: Tiago's 138 pairs compacted into 96 slots at nv 36,
    Spot's feet on the floor at nv 31 (26 static rows);
  * K1's block (4 scenarios) and K2's (2) within the 232,448 bytes a block
    may opt in to on the H100 at Tiago's world.
"""

import pytest
import torch

from robosuite_tpu_torch.ops import contact_solve, forward, tables
from robosuite_tpu_torch.physics import contact as C
from robosuite_tpu_torch.physics import engine
from tests.test_torch_kernels_host import K1_TOLS, _k1_args, _k1_outputs, _p
from tests.test_torch_kernels_pickplace import SMEM_LIMIT
from tests.test_torch_kernels_tendons import lib  # noqa: F401 (the harness fixture)

ROBOTS = ("PandaOmron", "Tiago", "SpotWithArm", "SpotWithArmFloating")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_WORLDS = {}


def world(robot):
    """The port's CPU Lift env with `robot` and 3 scenarios two zero-action
    policy steps after a reset, seeded velocities on every dof, made once."""
    if robot not in _WORLDS:
        import robosuite_tpu_torch

        env = robosuite_tpu_torch.make("Lift", robots=robot, reward_shaping=True, seed=0, device="cpu")
        s, _ = env.reset_batch(3, torch.Generator().manual_seed(15))
        for _ in range(2):
            s, _ = env.rollout_batch(s, torch.zeros(3, env.action_dim))
        qvel = s.physics.qvel + 0.2 * torch.randn(s.physics.qvel.shape, generator=torch.Generator().manual_seed(16))
        s.physics = type(s.physics)(qpos=s.physics.qpos.contiguous(), qvel=qvel.contiguous(), time=s.physics.time)
        _WORLDS[robot] = env, s
    return _WORLDS[robot]


@pytest.mark.parametrize("robot", ROBOTS)
def test_forward_kernel_matches_plain(lib, robot):  # noqa: F811
    env, s = world(robot)
    m = env.model
    q, qd = s.physics.qpos, s.physics.qvel
    B = q.shape[0]
    T = tables.pack(m)
    img = torch.empty(lib.rs_forward_tab(_p(T), None), dtype=torch.float32)
    lib.rs_forward_tab(_p(T), _p(img))
    out = torch.full((forward.out_views(forward.out_shapes(m, B))[1],), float("nan"))
    lib.rs_forward_threads(1, 4, _p(T), _p(img), _p(q), _p(qd), *_k1_args(forward.model_leaves(m, B)), _p(out), B)
    out = _k1_outputs(m, B, out)
    kin, M, bias = forward.forward_plain(m, q, qd, *forward.model_leaves(m, B))
    ref = dict(kin.__dict__, M=M, bias=bias)
    for k in forward.OUTPUTS:
        scale = max(1.0, float(ref[k].abs().max())) if k in K1_TOLS else 1.0
        assert float((out[k] - ref[k]).abs().max()) / scale <= K1_TOLS.get(k, 2e-5), k


@pytest.mark.parametrize("nt", [1, 32])
@pytest.mark.parametrize("robot", ["Tiago", "SpotWithArm"])
def test_contact_solve_matches_plain(lib, robot, nt):  # noqa: F811
    env, s = world(robot)
    m = env.model
    q, qd = s.physics.qpos, s.physics.qvel
    kin, M, bias = forward.forward_plain(m, q, qd, *forward.runtime_leaves(m, q.shape[0]))
    ctrl = env.run_controllers(kin, M, bias, q, qd, s.ctrl)
    qfrc, extra = engine.total_smooth_force(m, q, qd, ctrl, M, bias)
    JfT, aref, reg3, mu, act = C.solver_inputs(m, kin, C.narrowphase(m, kin), qd, m.timestep, None)
    args = [t.contiguous() for t in (M, JfT, aref, qfrc, qd, m.dof_damping + extra, reg3, mu, act)]
    K = act.shape[1]
    assert (K == C.ROW_CAP) == (robot == "Tiago") and int((act.sum(1) >= 1).sum()) == act.shape[0]
    B = M.shape[0]
    qv_p, f_p = contact_solve.vel_update_plain(*args, C.APGD_ITERS, C.POWER_ITERS, m.timestep)
    qv_k, f_k = torch.full_like(qv_p, float("nan")), torch.full_like(f_p, float("nan"))
    lib.rs_contact_solve_eq_threads(nt, *(_p(t) for t in args), _p(qv_k), _p(f_k), B, m.nv, K, 0, C.APGD_ITERS,
                                    C.POWER_ITERS, m.timestep)
    assert float((qv_k - qv_p).abs().max()) <= 1e-4 * max(1.0, float(qv_p.abs().max()))
    assert float((f_k - f_p).abs().max()) <= 1e-4 * max(1.0, float(f_p.abs().max()))


def test_carves_fit_the_card_at_tiago(lib):  # noqa: F811
    env, _ = world("Tiago")
    m = env.model
    T = tables.pack(m)
    k1 = 4 * lib.rs_k1_block_words_eq(_p(T), 4)
    k2 = 2 * 4 * ((lib.rs_k2_words_eq(m.nv, C.ROW_CAP, 0) + 3) // 4 * 4)
    print("Lift-Tiago K1 block", k1, "K2 block", k2)
    assert 0 < k1 <= SMEM_LIMIT and 0 < k2 <= SMEM_LIMIT
