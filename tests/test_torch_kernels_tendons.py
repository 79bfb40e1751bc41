"""K2's device code with bilateral equality rows, and K1's and K2's carves
at the raised maxima, compiled for the CPU (as
tests/test_torch_kernels_host.py does, over its harness):

  * K2 against vel_update_plain on the plain path's operands at a grasp
    state (ab_kernels.lift_grasp_state) of Lift-IIWA (ne 4 tendon rows,
    370 static rows), Lift-Jaco (ne 3 tendon rows after 96 compacted
    slots) and Lift-XArm7 (ne 7: two connects and a joint coupling), over
    one lane and over a 32-thread team (chip_smoke.py's tolerances: qvel
    and f 1e-4 of max(1, their largest));
  * the equality rows carry force: f on them is not zero, and the solve
    with them differs from the one without;
  * K1 at those states against forward_plain (poses 2e-5; M 1e-5 and bias
    1e-4 of their largest), 4 scenarios a block;
  * the shared memory of a K1 block (4 scenarios) at the four wide worlds
    (PickPlaceCan and NutAssemblySingle with Baxter and PandaDexRH) and of
    a K2 block (2) at their nv with 96 slots and at the kernel's maxima
    (nv 44, 96 slots, 8 equality rows) within the card's 232,448 bytes.
"""

import ctypes
import shutil
import subprocess

import pytest
import torch

from robosuite_tpu_torch import ab_kernels
from robosuite_tpu_torch.ops import build, contact_solve, forward, tables
from robosuite_tpu_torch.physics import contact as C
from robosuite_tpu_torch.physics import engine, equality
from tests.test_torch_kernels_host import CARD_ONLY, CSRC, HARNESS, HOST_ONLY, K1_TOLS, _k1_args, _k1_outputs, _p
from tests.test_torch_kernels_pickplace import SMEM_LIMIT

ROBOTS = ("IIWA", "Jaco", "XArm7")
NE = {"IIWA": 4, "Jaco": 3, "XArm7": 7}

# K2 with equality rows over a team of nt CPU threads, and the words of a
# K1 block of S scenarios and of one K2 scenario
EXTRA = r"""
extern "C" int rs_contact_solve_eq_threads(int nt, const float* M, const float* JfT, const float* aref,
    const float* qfrc, const float* qvel, const float* damping, const float* reg3, const float* mu,
    const float* active, float* qvel_out, float* f_out, int B, int nv, int K, int ne, int iters, int power_iters,
    float dt) {
  Solve s;
  float* Msh;
  Carver n{nullptr, 0};
  carve_k2(nv, K, ne, n, Msh, s);
  for (int b = 0; b < B; ++b) {
    std::vector<double> buf;
    Carver c{scratch(buf, n.w), 0};
    carve_k2(nv, K, ne, c, Msh, s);
    auto body = [&](const auto& tm) {
      contact_solve_body(tm, s, Msh, b, nv, K, iters, power_iters, dt, M, JfT, aref, qfrc, qvel, damping, reg3,
                         mu, active, qvel_out, f_out);
    };
    if (nt == 1) body(HostTeam());
    else on_team(nt, [&](const ThreadTeam& tm) { body(tm); });
  }
  return 0;
}
extern "C" int rs_k1_block_words_eq(const void* T, int S) {
  FwdTab F;
  Fwd f;
  Frames fr;
  return carve_k1(*(const RsTables*)T, nullptr, S, 0, F, f, fr);
}
extern "C" int rs_k2_words_eq(int nv, int K, int ne) {
  Solve s;
  float* Msh;
  Carver n{nullptr, 0};
  carve_k2(nv, K, ne, n, Msh, s);
  return n.w;
}
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
    d = tmp_path_factory.mktemp("kernels_tendons")
    src, so = d / "harness.cpp", d / "libharness.so"
    src.write_text(HARNESS + EXTRA)
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-pthread", f"-I{CSRC}", str(src), "-o", str(so)],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    signatures = {**build._SIGNATURES, **HOST_ONLY,
                  "rs_contact_solve_eq_threads": [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                  + [ctypes.c_float],
                  "rs_k1_block_words_eq": [ctypes.c_void_p, ctypes.c_int], "rs_k2_words_eq": [ctypes.c_int] * 3}
    for name, args in signatures.items():
        if name not in CARD_ONLY:
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = ctypes.c_int
    assert lib.rs_tables_size() == ctypes.sizeof(tables.RsTables)
    return lib


_WORLDS = {}


def world(robot):
    """The port's CPU Lift env with `robot` and 3 scenarios of its grasp
    state, made once."""
    if robot not in _WORLDS:
        import robosuite_tpu_torch

        env = robosuite_tpu_torch.make("Lift", robots=robot, reward_shaping=True, seed=0, device="cpu")
        s, _ = env.reset_batch(3, torch.Generator().manual_seed(14))
        _WORLDS[robot] = env, ab_kernels.lift_grasp_state(env, s)
    return _WORLDS[robot]


def _k2_operands(robot, with_eq=True):
    """The plain path's K2 operands at the grasp state, and K."""
    env, s = world(robot)
    m = env.model
    q, qd = s.physics.qpos, s.physics.qvel
    kin, M, bias = forward.forward_plain(m, q, qd, *forward.runtime_leaves(m, q.shape[0]))
    ctrl = env.run_controllers(kin, M, bias, q, qd, s.ctrl)
    qfrc, extra = engine.total_smooth_force(m, q, qd, ctrl, M, bias)
    eq = equality.equality_rows(m, kin, q, qd) if with_eq else None
    JfT, aref, reg3, mu, act = C.solver_inputs(m, kin, C.narrowphase(m, kin), qd, m.timestep, eq)
    return [t.contiguous() for t in (M, JfT, aref, qfrc, qd, m.dof_damping + extra, reg3, mu, act)], act.shape[1]


@pytest.mark.parametrize("nt", [1, 32])
@pytest.mark.parametrize("robot", ROBOTS)
def test_contact_solve_with_equality_rows_matches_plain(lib, robot, nt):
    """K2 with ne equality rows against vel_update_plain: qvel and f 1e-4
    of max(1, their largest), over one lane and a 32-thread team; the
    equality rows carry force."""
    env, _ = world(robot)
    m = env.model
    args, K = _k2_operands(robot)
    ne = args[1].shape[2] - 3 * K
    assert ne == NE[robot] == equality.equality_row_count(m)
    assert (K == C.ROW_CAP) == (robot == "Jaco")
    assert int((args[-1].sum(1) >= 1).sum()) >= 2
    B = args[0].shape[0]
    qv_p, f_p = contact_solve.vel_update_plain(*args, C.APGD_ITERS, C.POWER_ITERS, m.timestep)
    qv_k, f_k = torch.full_like(qv_p, float("nan")), torch.full_like(f_p, float("nan"))
    lib.rs_contact_solve_eq_threads(nt, *(_p(t) for t in args), _p(qv_k), _p(f_k), B, m.nv, K, ne, C.APGD_ITERS,
                                    C.POWER_ITERS, m.timestep)
    assert float((qv_k - qv_p).abs().max()) <= 1e-4 * max(1.0, float(qv_p.abs().max()))
    assert float((f_k - f_p).abs().max()) <= 1e-4 * max(1.0, float(f_p.abs().max()))
    assert float(f_p[:, 3 * K:].abs().min(dim=1).values.max()) > 0.0
    no_eq, _ = _k2_operands(robot, with_eq=False)
    qv_n, _ = contact_solve.vel_update_plain(*no_eq, C.APGD_ITERS, C.POWER_ITERS, m.timestep)
    assert float((qv_n - qv_p).abs().max()) > 1e-3


@pytest.mark.parametrize("robot", ROBOTS)
def test_forward_kernel_matches_plain_on_tendon_worlds(lib, robot):
    """K1 at the grasp state of each tendon world (its `general` and
    tendon actuators in the model, which K1's table does not pack) against
    forward_plain, 4 scenarios a block."""
    env, s = world(robot)
    m = env.model
    q, qd = s.physics.qpos.contiguous(), s.physics.qvel.contiguous()
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


WIDE = (("PickPlaceCan", "Baxter"), ("PickPlaceCan", "PandaDexRH"), ("NutAssemblySingle", "Baxter"),
        ("NutAssemblySingle", "PandaDexRH"))


def test_carves_fit_the_card_at_the_new_maxima(lib):
    """K1's block (RS_S_FORWARD = 4 scenarios) at each wide world and K2's
    (RS_S_SOLVE = 2) at its nv with 96 slots, within the 232,448 bytes a
    block may opt in to on the H100; and at the maxima (nv 60 since GR1,
    96 slots, 8 equality rows) K2's block of 2 past them, so the launcher
    takes its one-scenario block (RS_S_SOLVE_WIDE), which fits."""
    import robosuite_tpu_torch

    for name, robot in WIDE:
        m = robosuite_tpu_torch.make(name, robots=robot, device="cpu").model
        T = tables.pack(m)
        k1 = 4 * lib.rs_k1_block_words_eq(_p(T), 4)
        k2 = 2 * 4 * ((lib.rs_k2_words_eq(m.nv, C.ROW_CAP, 0) + 3) // 4 * 4)
        print(name, robot, m.nq, m.nv, m.nsite, "K1 block", k1, "K2 block", k2)
        assert 0 < k1 <= SMEM_LIMIT and 0 < k2 <= SMEM_LIMIT, (name, robot, k1, k2)
    k2_max = 4 * ((lib.rs_k2_words_eq(tables.MAXV, C.ROW_CAP, tables.MAXE) + 3) // 4 * 4)
    print("K2 at the maxima: one scenario", k2_max, "B, a block of 2", 2 * k2_max, "B")
    assert 2 * k2_max > SMEM_LIMIT >= k2_max
    assert lib.rs_k2_words_eq(19, 10, 7) > lib.rs_k2_words_eq(19, 10, 0) + 19 * 7
