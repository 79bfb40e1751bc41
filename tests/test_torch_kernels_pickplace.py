"""The kernels' device code at Sawyer + PickPlaceCan's widths, compiled for
the CPU (as tests/test_torch_kernels_host.py does, over its harness):
this world is the first above the maxima of the earlier slices (nq 37,
nv 33, 40 bodies, 105 geoms) and the first to put K2 on its main path,
at 96 compacted contact slots.

  * K1 at the contact state (ab_kernels.pickplace_contact_state) against
    its plain version, over one lane and over a 32-thread team, 4
    scenarios a block with a ragged last block; its table has no contact
    part (606 pairs are above the fused substep's maxima);
  * K2 at nv 33 and 96 compacted slots, on the plain path's operands at
    that state, against vel_update_plain, over one lane and a 32-thread
    team (chip_smoke.py's tolerances);
  * the shared memory of a K1 block (4 scenarios) and of a K2 block (2)
    at this world's sizes within the card's 227 KB;
  * the maxima: PickPlaceCan and TwoArmTransport (53 bodies, nv 36) fit
    K1 and K2, a world one past each maximum (nbody 56, njnt 24, nq 40, nv
    36, ngeom 176, nsite 24, nu 24) is refused, and the fused substep's
    gate refuses PickPlaceCan for its row compaction.
"""

import copy
import ctypes
import shutil
import subprocess

import pytest
import torch

from robosuite_tpu_torch import ab_kernels
from robosuite_tpu_torch.ops import build, contact_solve, forward, substep, tables
from robosuite_tpu_torch.physics import contact as C
from robosuite_tpu_torch.physics import engine
from tests.test_torch_kernels_host import CARD_ONLY, CSRC, HARNESS, HOST_ONLY, K1_TOLS, _k1_args, _k1_outputs, _p

KW = dict(robots="Sawyer", controller_configs="JOINT_POSITION", reward_shaping=True)

# K2 over a team of nt CPU threads (one scenario after another), and the
# words of a K1 block of S scenarios and of one K2 scenario
EXTRA = r"""
extern "C" int rs_contact_solve_threads(int nt, const float* M, const float* JfT, const float* aref,
    const float* qfrc, const float* qvel, const float* damping, const float* reg3, const float* mu,
    const float* active, float* qvel_out, float* f_out, int B, int nv, int K, int iters, int power_iters, float dt) {
  Solve s;
  float* Msh;
  Carver n{nullptr, 0};
  carve_k2(nv, K, 0, n, Msh, s);
  for (int b = 0; b < B; ++b) {
    std::vector<double> buf;
    Carver c{scratch(buf, n.w), 0};
    carve_k2(nv, K, 0, c, Msh, s);
    auto body = [&](const auto& tm) {
      contact_solve_body(tm, s, Msh, b, nv, K, iters, power_iters, dt, M, JfT, aref, qfrc, qvel, damping, reg3,
                         mu, active, qvel_out, f_out);
    };
    if (nt == 1) body(HostTeam());
    else on_team(nt, [&](const ThreadTeam& tm) { body(tm); });
  }
  return 0;
}
extern "C" int rs_k1_block_words(const void* T, int S) {
  FwdTab F;
  Fwd f;
  Frames fr;
  return carve_k1(*(const RsTables*)T, nullptr, S, 0, F, f, fr);
}
extern "C" int rs_k2_words(int nv, int K) {
  Solve s;
  float* Msh;
  Carver n{nullptr, 0};
  carve_k2(nv, K, 0, n, Msh, s);
  return n.w;
}
"""
SMEM_LIMIT = 232448  # bytes of shared memory a block may opt in to on the H100 (227 KB)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernels' device code for the CPU")
    d = tmp_path_factory.mktemp("kernels_pickplace")
    src, so = d / "harness.cpp", d / "libharness.so"
    src.write_text(HARNESS + EXTRA)
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-pthread", f"-I{CSRC}", str(src), "-o", str(so)],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    signatures = {**build._SIGNATURES, **HOST_ONLY,
                  "rs_contact_solve_threads": [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                  + [ctypes.c_float],
                  "rs_k1_block_words": [ctypes.c_void_p, ctypes.c_int], "rs_k2_words": [ctypes.c_int] * 2}
    for name, args in signatures.items():
        if name not in CARD_ONLY:
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = ctypes.c_int
    assert lib.rs_tables_size() == ctypes.sizeof(tables.RsTables)
    return lib


@pytest.fixture(scope="module")
def pick():
    """The port's PickPlaceCan env (CPU) and 5 scenarios of its contact
    state (the pads closed on the can, the objects in bin 1)."""
    import robosuite_tpu_torch

    env = robosuite_tpu_torch.make("PickPlaceCan", device="cpu", **KW)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    s, _ = env.reset_batch(5, torch.Generator().manual_seed(4))
    s = ab_kernels.pickplace_contact_state(env, s)
    torch.set_num_threads(n)
    return env, s


@pytest.mark.parametrize("nt", [1, 32])
def test_forward_kernel_matches_plain(lib, pick, nt):
    """K1 at nv 33, 40 bodies, 105 geoms: every output against
    forward_plain (poses 2e-5; M 1e-5 and bias 1e-4 of their largest), 4
    scenarios a block (the 5th alone), the model's leaves at batch stride
    0, its table and image without the contact part."""
    env, s = pick
    m = env.model
    q, qd = s.physics.qpos.contiguous(), s.physics.qvel.contiguous()
    B = q.shape[0]
    T = tables.pack(m)
    img = torch.empty(lib.rs_forward_tab(_p(T), None), dtype=torch.float32)
    lib.rs_forward_tab(_p(T), _p(img))
    out = torch.full((forward.out_views(forward.out_shapes(m, B))[1],), float("nan"))
    lib.rs_forward_threads(nt, 4, _p(T), _p(img), _p(q), _p(qd), *_k1_args(forward.model_leaves(m, B)), _p(out), B)
    out = _k1_outputs(m, B, out)
    kin, M, bias = forward.forward_plain(m, q, qd, *forward.model_leaves(m, B))
    ref = dict(kin.__dict__, M=M, bias=bias)
    for k in forward.OUTPUTS:
        scale = max(1.0, float(ref[k].abs().max())) if k in K1_TOLS else 1.0
        assert float((out[k] - ref[k]).abs().max()) / scale <= K1_TOLS.get(k, 2e-5), k


@pytest.fixture(scope="module")
def k2_operands(pick):
    """The plain path's K2 operands at the contact state: 96 compacted
    slots (288 rows), at least 4 active in every scenario."""
    env, s = pick
    m = env.model
    B = s.physics.qpos.shape[0]
    q, qd = s.physics.qpos, s.physics.qvel
    kin, M, bias = forward.forward_plain(m, q, qd, *forward.runtime_leaves(m, B))
    ctrl = env.robots[0].run_controllers(kin, M, bias, q, qd, s.ctrl, torch.zeros(B, m.nu))
    qfrc, extra = engine.total_smooth_force(m, q, qd, ctrl, M, bias)
    JfT, aref, reg3, mu, act = C.solver_inputs(m, kin, C.narrowphase(m, kin), qd, m.timestep)
    assert act.shape == (B, C.ROW_CAP) and JfT.shape == (B, 33, 288)
    assert int(act.sum(1).min()) >= 4
    return [t.contiguous() for t in (M, JfT, aref, qfrc, qd, m.dof_damping + extra, reg3, mu, act)]


@pytest.mark.parametrize("nt", [1, 32])
def test_contact_solve_kernel_matches_plain(lib, pick, k2_operands, nt):
    """K2 at nv 33 and 96 compacted slots against vel_update_plain: qvel
    1e-4 of max(1, its largest) and f 1e-4 of max(1, its largest) (the
    light can, 14 g at the card's density, turns f's float32 rounding into
    velocity), over one lane and over a 32-thread team."""
    env, _ = pick
    m = env.model
    args = k2_operands
    B = args[0].shape[0]
    qv_p, f_p = contact_solve.vel_update_plain(*args, C.APGD_ITERS, C.POWER_ITERS, m.timestep)
    qv_k, f_k = torch.full_like(qv_p, float("nan")), torch.full_like(f_p, float("nan"))
    lib.rs_contact_solve_threads(nt, *(_p(t) for t in args), _p(qv_k), _p(f_k), B, m.nv, C.ROW_CAP, C.APGD_ITERS,
                                 C.POWER_ITERS, m.timestep)
    assert float((qv_k - qv_p).abs().max()) <= 1e-4 * max(1.0, float(qv_p.abs().max()))
    assert float((f_k - f_p).abs().max()) <= 1e-4 * max(1.0, float(f_p.abs().max()))


def test_carves_fit_the_card(lib, pick):
    """K1's block (RS_S_FORWARD = 4 scenarios) and K2's (RS_S_SOLVE = 2) at
    this world's sizes within the 227 KB a block may opt in to; K2's
    scenario holds Y (nv x (3 K | 1) floats) beside M, L and the rows."""
    env, _ = pick
    m = env.model
    T = tables.pack(m)
    k1 = 4 * lib.rs_k1_block_words(_p(T), 4)
    k2 = 2 * 4 * ((lib.rs_k2_words(m.nv, C.ROW_CAP) + 3) // 4 * 4)
    assert 0 < k1 <= SMEM_LIMIT and 0 < k2 <= SMEM_LIMIT
    assert lib.rs_k2_words(m.nv, C.ROW_CAP) > m.nv * (3 * C.ROW_CAP + 1)


def test_maxima_take_pickplace_and_refuse_more(pick):
    """PickPlaceCan fits K1's and K2's maxima (raised since for the
    two-arm worlds, tests/test_torch_kernels_twoarm.py, for PickPlace
    and NutAssembly with Baxter and PandaDexRH, tests/test_torch_tendon_robots.py,
    for Lift-Tiago, tests/test_torch_mobile_robots.py, and for GR1: 96
    bodies, 56 joints, nq 64, nv 60, 52 sites,
    tests/test_torch_gr1_kernels.py), and so does
    TwoArmTransport (53 bodies, nq 39, nv 36, 23 sites); a model one past
    any of the maxima is refused by K1's table and K2's sizes, the
    actuators only where the fused substep packs them (K1 and K4 read
    none); the fused substep's gate refuses PickPlaceCan for its row
    compaction before any maximum."""
    import robosuite_tpu_torch

    env, _ = pick
    m = env.model
    assert (tables.MAXB, tables.MAXJ, tables.MAXQ, tables.MAXV, tables.MAXG, tables.MAXS, tables.MAXU) == (
        96, 56, 64, 60, 176, 52, 24)
    assert tables.check_model(m, contacts=False) == 0
    contact_solve.check_sizes(m.nv, C.ROW_CAP)
    big_world = robosuite_tpu_torch.make("TwoArmTransport", robots=("Panda", "Panda"), device="cpu").model
    assert (big_world.nbody, big_world.nq, big_world.nv, big_world.nsite) == (53, 39, 36, 23)
    assert tables.check_model(big_world, contacts=False) == 0
    contact_solve.check_sizes(big_world.nv, C.ROW_CAP)
    for name, cap in (("nbody", tables.MAXB), ("njnt", tables.MAXJ), ("nq", tables.MAXQ), ("nv", tables.MAXV),
                      ("ngeom", tables.MAXG), ("nsite", tables.MAXS)):
        big = copy.copy(m)
        setattr(big, name, cap + 1)
        with pytest.raises(ValueError, match=f"{name}={cap + 1}"):
            tables.check_model(big, contacts=False)
    big = copy.copy(m)
    big.nu = tables.MAXU + 1
    assert tables.check_model(big, contacts=False) == 0
    with pytest.raises(ValueError, match=f"nu={tables.MAXU + 1}"):
        tables.check_model(big, contacts=True)
    with pytest.raises(ValueError, match="nv=61"):
        contact_solve.check_sizes(tables.MAXV + 1, C.ROW_CAP)
    with pytest.raises(ValueError, match="K=193"):
        contact_solve.check_sizes(m.nv, tables.MAXK + 1)
    with pytest.raises(substep.UnsupportedFused, match="compacts"):
        substep.extract_spec(env, m)
