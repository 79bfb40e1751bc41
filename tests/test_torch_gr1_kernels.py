"""K1, K2 and K4 at GR1's widths (92 bodies; nv 42 to 60), compiled for the
CPU (the host build of tests/test_torch_kernels_tendons.py's harness),
against their plain versions:

  * K1 against forward_plain (poses 2e-5; M 1e-5 and bias 1e-4 of their
    largest; chip_smoke.py's tolerances) at each of GR1 (nq 61, nv 60, 55
    joints, 51 sites, 681 (body, dof) pairs), GR1FixedLowerBody,
    GR1FloatingBody (885 pairs) and GR1ArmsOnly, in blocks of the
    scenarios the launcher picks for the world (2 where 4 do not fit the
    card's shared memory), at states two policy steps after a reset with
    seeded velocities on every dof;
  * K2 against vel_update_plain (qvel and f 1e-4 of max(1, their
    largest)) on the plain path's operands there, over one lane and a
    32-thread team: GR1's 558 pairs compacted into 96 slots at nv 60, and
    GR1ArmsOnly's 311 at nv 42;
  * K4 against fk_pose_plain (2e-5) at GR1's 92 bodies, 32 scenarios a
    block;
  * the blocks within the 232,448 bytes a block may opt in to on the H100:
    K1 at 2 scenarios on the wide worlds (286,112 B at 4 on GR1), 4 on
    GR1ArmsOnly; K2 at one scenario at nv 60 with 96 slots (244,224 B at
    2), 2 at nv 42-51; K4 at 32; and the maxima taking GR1's world.
"""

import ctypes
import shutil
import subprocess

import pytest
import torch

from robosuite_tpu_torch.ops import build, contact_solve, fk, forward, tables
from robosuite_tpu_torch.physics import contact as C
from robosuite_tpu_torch.physics import engine
from tests.test_torch_kernels_host import (CARD_ONLY, CSRC, HARNESS, HOST_ONLY, K1_TOLS, _fk_run, _image, _k1_args,
                                          _k1_outputs, _p)
from tests.test_torch_kernels_pickplace import SMEM_LIMIT
from tests.test_torch_kernels_tendons import EXTRA

ROBOTS = ("GR1", "GR1FixedLowerBody", "GR1FloatingBody", "GR1ArmsOnly")

# the words of a K4 block of S scenarios, beside the tendon harness's K1 and K2 words
FK_WORDS = r"""
extern "C" int rs_fk_block_words(const void* T, int S) { return fk_block_words(*(const RsTables*)T, S); }
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernels' device code for the CPU")
    d = tmp_path_factory.mktemp("kernels_gr1")
    src, so = d / "harness.cpp", d / "libharness.so"
    src.write_text(HARNESS + EXTRA + FK_WORDS)
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-pthread", f"-I{CSRC}", str(src), "-o", str(so)],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    signatures = {**build._SIGNATURES, **HOST_ONLY,
                  "rs_contact_solve_eq_threads": [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                  + [ctypes.c_float],
                  "rs_k1_block_words_eq": [ctypes.c_void_p, ctypes.c_int], "rs_k2_words_eq": [ctypes.c_int] * 3,
                  "rs_fk_block_words": [ctypes.c_void_p, ctypes.c_int]}
    for name, args in signatures.items():
        if name not in CARD_ONLY:
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = ctypes.c_int
    assert lib.rs_tables_size() == ctypes.sizeof(tables.RsTables)
    return lib


_WORLDS = {}


def world(robot):
    """The port's CPU Lift env with `robot` and 3 scenarios two zero-action
    policy steps after a reset, seeded velocities on every dof, made once."""
    if robot not in _WORLDS:
        import robosuite_tpu_torch

        env = robosuite_tpu_torch.make("Lift", robots=robot, reward_shaping=True, seed=0, device="cpu")
        s, _ = env.reset_batch(3, torch.Generator().manual_seed(16))
        for _ in range(2):
            s, _ = env.rollout_batch(s, torch.zeros(3, env.action_dim))
        qvel = s.physics.qvel + 0.2 * torch.randn(s.physics.qvel.shape, generator=torch.Generator().manual_seed(17))
        s.physics = type(s.physics)(qpos=s.physics.qpos.contiguous(), qvel=qvel.contiguous(), time=s.physics.time)
        _WORLDS[robot] = env, s
    return _WORLDS[robot]


def k1_scenarios(lib, T):
    """The scenarios a K1 block holds on the card (csrc/forward.cu k1_block):
    4 where that block fits the card's shared memory, else 2."""
    return 4 if 4 * lib.rs_k1_block_words_eq(_p(T), 4) <= SMEM_LIMIT else 2


@pytest.mark.parametrize("robot", ROBOTS)
def test_forward_kernel_matches_plain(lib, robot):
    env, s = world(robot)
    m = env.model
    q, qd = s.physics.qpos, s.physics.qvel
    B = q.shape[0]
    T = tables.pack(m)
    img = _image(lib, T)
    out = torch.full((forward.out_views(forward.out_shapes(m, B))[1],), float("nan"))
    lib.rs_forward_threads(1, k1_scenarios(lib, T), _p(T), _p(img), _p(q), _p(qd),
                           *_k1_args(forward.model_leaves(m, B)), _p(out), B)
    out = _k1_outputs(m, B, out)
    kin, M, bias = forward.forward_plain(m, q, qd, *forward.model_leaves(m, B))
    ref = dict(kin.__dict__, M=M, bias=bias)
    for k in forward.OUTPUTS:
        scale = max(1.0, float(ref[k].abs().max())) if k in K1_TOLS else 1.0
        assert float((out[k] - ref[k]).abs().max()) / scale <= K1_TOLS.get(k, 2e-5), k


@pytest.mark.parametrize("nt", [1, 32])
@pytest.mark.parametrize("robot", ["GR1", "GR1ArmsOnly"])
def test_contact_solve_matches_plain(lib, robot, nt):
    env, s = world(robot)
    m = env.model
    q, qd = s.physics.qpos, s.physics.qvel
    kin, M, bias = forward.forward_plain(m, q, qd, *forward.runtime_leaves(m, q.shape[0]))
    ctrl = env.run_controllers(kin, M, bias, q, qd, s.ctrl)
    qfrc, extra = engine.total_smooth_force(m, q, qd, ctrl, M, bias)
    JfT, aref, reg3, mu, act = C.solver_inputs(m, kin, C.narrowphase(m, kin), qd, m.timestep, None)
    args = [t.contiguous() for t in (M, JfT, aref, qfrc, qd, m.dof_damping + extra, reg3, mu, act)]
    K = act.shape[1]
    assert K == C.ROW_CAP and int((act.sum(1) >= 4).sum()) == act.shape[0]
    B = M.shape[0]
    qv_p, f_p = contact_solve.vel_update_plain(*args, C.APGD_ITERS, C.POWER_ITERS, m.timestep)
    qv_k, f_k = torch.full_like(qv_p, float("nan")), torch.full_like(f_p, float("nan"))
    lib.rs_contact_solve_eq_threads(nt, *(_p(t) for t in args), _p(qv_k), _p(f_k), B, m.nv, K, 0, C.APGD_ITERS,
                                    C.POWER_ITERS, m.timestep)
    assert float((qv_k - qv_p).abs().max()) <= 1e-4 * max(1.0, float(qv_p.abs().max()))
    assert float((f_k - f_p).abs().max()) <= 1e-4 * max(1.0, float(f_p.abs().max()))


def test_fk_kernel_matches_plain(lib):
    env, s = world("GR1")
    m, q = env.model, s.physics.qpos
    xp_k, xq_k = _fk_run(lib, m, q, 32)
    xp_p, xq_p = fk.fk_pose_plain(m, q)
    assert float((xp_k - xp_p).abs().max()) <= 2e-5 and float((xq_k - xq_p).abs().max()) <= 2e-5


@pytest.mark.parametrize("robot", ROBOTS)
def test_blocks_fit_the_card(lib, robot):
    env, _ = world(robot)
    m = env.model
    T = tables.pack(m)
    S1 = k1_scenarios(lib, T)
    k1 = 4 * lib.rs_k1_block_words_eq(_p(T), S1)
    k2_one = 4 * ((lib.rs_k2_words_eq(m.nv, C.ROW_CAP, 0) + 3) // 4 * 4)
    S2 = 2 if 2 * k2_one <= SMEM_LIMIT else 1
    k4 = 4 * lib.rs_fk_block_words(_p(T), 32)
    print(f"Lift-{robot} K1 block {k1} B ({S1} scenarios), K2 block {S2 * k2_one} B ({S2}), K4 block {k4} B (32)")
    assert 0 < k1 <= SMEM_LIMIT and 0 < S2 * k2_one <= SMEM_LIMIT and 0 < k4 <= SMEM_LIMIT
    assert S1 == (4 if robot == "GR1ArmsOnly" else 2) and S2 == (1 if m.nv == 60 else 2)
    if robot == "GR1":
        assert 4 * lib.rs_k1_block_words_eq(_p(T), 4) == 286112 and 2 * k2_one == 244224
        assert (m.nbody, m.njnt, m.nq, m.nv, m.nsite) == (92, 55, 61, 60, 51) <= (
            tables.MAXB, tables.MAXJ, tables.MAXQ, tables.MAXV, tables.MAXS)
    assert int(m.ancestor_mask.count_nonzero()) == tables.fill(m).npr <= tables.MAXPR
    contact_solve.check_sizes(m.nv, C.ROW_CAP)
