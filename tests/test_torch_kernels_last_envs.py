"""The kernels' device code at the last task envs' widths, compiled for the
CPU (as tests/test_torch_kernels_host.py does, over its harness):
ToolHang (Panda, OSC_POSE: nq 30, nv 27, 28 bodies, 102 geoms, 14 sites)
and TwoArmTransport (two Pandas: nq 39, nv 36 -- K2's dof maximum -- 53
bodies, past K1's earlier body maximum of 48, 170 geoms, 23 sites), both
compacting their rows into 96 slots.

  * K1 at each world's contact state (ab_kernels.tool_hang_contact_state,
    ab_kernels.transport_contact_state) against its plain version, over
    one lane and over a 32-thread team, 4 scenarios a block with a ragged
    last block;
  * K2 against vel_update_plain on the plain path's operands at those
    states, nv 27 and nv 36 with 96 compacted slots, over one lane and a
    32-thread team (chip_smoke.py's tolerances);
  * the shared memory of a K1 block (4 scenarios) and of a K2 block (2) at
    each world's sizes within the card's 227 KB;
  * the table's prefix lists at nv == RS_MAXV and nbody 53: the (body,
    dof) pair lists end where the table's arrays do not overflow.
"""

import ctypes
import shutil
import subprocess

import pytest
import torch

from robosuite_tpu_torch import ab_kernels
from robosuite_tpu_torch.ops import build, contact_solve, forward, tables
from robosuite_tpu_torch.physics import contact as C
from robosuite_tpu_torch.physics import engine
from tests.test_torch_kernels_host import CARD_ONLY, CSRC, HARNESS, HOST_ONLY, K1_TOLS, _k1_args, _k1_outputs, _p
from tests.test_torch_kernels_pickplace import EXTRA, SMEM_LIMIT

NAMES = ("ToolHang", "TwoArmTransport")
STATE_FN = {"ToolHang": ab_kernels.tool_hang_contact_state, "TwoArmTransport": ab_kernels.transport_contact_state}
MAKE = {"ToolHang": dict(robots="Panda"), "TwoArmTransport": dict(robots=("Panda", "Panda"))}
SIZES = {"ToolHang": (30, 27, 28), "TwoArmTransport": (39, 36, 53)}  # nq, nv, nbody


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
    d = tmp_path_factory.mktemp("kernels_last_envs")
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


_WORLDS = {}


def world(name):
    """The port's CPU env and 5 scenarios of its contact state, made once."""
    if name not in _WORLDS:
        import robosuite_tpu_torch

        env = robosuite_tpu_torch.make(name, reward_shaping=True, device="cpu", **MAKE[name])
        s, _ = env.reset_batch(5, torch.Generator().manual_seed(15))
        _WORLDS[name] = env, STATE_FN[name](env, s)
    return _WORLDS[name]


@pytest.mark.parametrize("nt", [1, 32])
@pytest.mark.parametrize("name", NAMES)
def test_forward_kernel_matches_plain(lib, name, nt):
    """K1 at the world's sizes: every output against forward_plain (poses
    2e-5; M 1e-5 and bias 1e-4 of their largest), 4 scenarios a block (the
    5th alone), the model's leaves at batch stride 0."""
    env, s = world(name)
    m = env.model
    assert (m.nq, m.nv, m.nbody) == SIZES[name]
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


def _k2_operands(name):
    """The plain path's K2 operands at the contact state and the rows (K)."""
    env, s = world(name)
    m = env.model
    B = s.physics.qpos.shape[0]
    q, qd = s.physics.qpos, s.physics.qvel
    kin, M, bias = forward.forward_plain(m, q, qd, *forward.runtime_leaves(m, B))
    ctrl = env.run_controllers(kin, M, bias, q, qd, s.ctrl)
    qfrc, extra = engine.total_smooth_force(m, q, qd, ctrl, M, bias)
    JfT, aref, reg3, mu, act = C.solver_inputs(m, kin, C.narrowphase(m, kin), qd, m.timestep)
    return [t.contiguous() for t in (M, JfT, aref, qfrc, qd, m.dof_damping + extra, reg3, mu, act)], act.shape[1]


@pytest.mark.parametrize("nt", [1, 32])
@pytest.mark.parametrize("name", NAMES)
def test_contact_solve_kernel_matches_plain(lib, name, nt):
    """K2 against vel_update_plain at the world's width (nv 27 and nv 36,
    each with 96 compacted slots), 8 active rows or more in every
    scenario: qvel 1e-4 of max(1, its largest) and f 1e-4 of max(1, its
    largest), over one lane and over a 32-thread team."""
    env, _ = world(name)
    m = env.model
    args, K = _k2_operands(name)
    assert (m.nv, K) == (SIZES[name][1], C.ROW_CAP)
    assert bool((args[-1].sum(1) >= 8).all())
    B = args[0].shape[0]
    qv_p, f_p = contact_solve.vel_update_plain(*args, C.APGD_ITERS, C.POWER_ITERS, m.timestep)
    qv_k, f_k = torch.full_like(qv_p, float("nan")), torch.full_like(f_p, float("nan"))
    lib.rs_contact_solve_threads(nt, *(_p(t) for t in args), _p(qv_k), _p(f_k), B, m.nv, K, C.APGD_ITERS,
                                 C.POWER_ITERS, m.timestep)
    assert float((qv_k - qv_p).abs().max()) <= 1e-4 * max(1.0, float(qv_p.abs().max()))
    assert float((f_k - f_p).abs().max()) <= 1e-4 * max(1.0, float(f_p.abs().max()))


@pytest.mark.parametrize("name", NAMES)
def test_carves_and_prefix_tables_fit(lib, name):
    """K1's block (RS_S_FORWARD = 4 scenarios) and K2's (RS_S_SOLVE = 2) at
    the world's sizes within the 227 KB a block may opt in to; the table's
    prefix lists over the dofs (nv + 1 entries) and the bodies (nbody + 1)
    end at the pair count, within RS_MAXV + 1 and RS_MAXB + 1, and the
    mass matrix's sources fill nv * nv entries of RS_MAXV^2."""
    env, _ = world(name)
    m = env.model
    K = C.contact_warmstart_dim(m) // 3
    T = tables.pack(m)
    k1 = 4 * lib.rs_k1_block_words(_p(T), 4)
    k2 = 2 * 4 * ((lib.rs_k2_words(m.nv, K) + 3) // 4 * 4)
    assert 0 < k1 <= SMEM_LIMIT and 0 < k2 <= SMEM_LIMIT
    t = tables.fill(m)
    dof0, body0 = list(t.dof_pr0), list(t.body_pr0)
    assert len(dof0) == tables.MAXV + 1 and len(body0) == tables.MAXB + 1
    assert dof0[m.nv] == body0[m.nbody] == t.npr == int(m.ancestor_mask.count_nonzero()) <= tables.MAXPR
    assert all(a <= b for a, b in zip(dof0[:m.nv], dof0[1:m.nv + 1]))
    assert all(a <= b for a, b in zip(body0[:m.nbody], body0[1:m.nbody + 1]))
    src = list(t.m_rc)[:m.nv * m.nv]
    assert len(t.m_rc) == tables.MAXV * tables.MAXV and max(src) < 256 * m.nv
