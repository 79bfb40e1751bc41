"""The CUDA kernels' arithmetic, checked without a GPU: the device code in
robosuite_tpu_torch/csrc/*.cuh is written as functions over a team of
lanes that also compile as plain C++ over the one-lane host team
(csrc/common.cuh HostTeam), so this test builds it with the host C++
compiler, runs K1, K2, K3, K3's emit_aux variant and K4 scenario by
scenario on CPU tensors, each scenario in a shared-memory carve of its own, and holds each against its
plain PyTorch version with the tolerances chip_smoke.py uses on the card;
on the Lift world (OSC) and on the Stack world (JOINT_POSITION: K2, K3-JP
and K3-aux-JP at nv 21, 96 rows, which also exercises the kernels'
compile-time maxima and sizeof(RsTables)).
It also holds the fused substep's carve size (C) to ops/tables.py's mirror,
and the manifold cut's tie rule to contact.select_deepest; and runs K3 and
the cut over a team of CPU threads (ThreadTeam below: rank, size, a
barrier for sync, sums, ballot and argmin through a shared buffer), so the
lane-strided loops, the active-row compaction and the team argmin run with
32 lanes as on the card. Launch configuration, warp shuffles and shared
memory are exercised only on the card."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import robosuite_tpu_torch
from robosuite_tpu_torch import ab_kernels
from robosuite_tpu_torch.ops import build, contact_solve, fk, forward, substep, tables
from robosuite_tpu_torch.physics import contact as C
from robosuite_tpu_torch.physics import engine

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "robosuite_tpu_torch", "csrc")

# The kernel library's C entry points, run scenario by scenario over the
# one-lane host team, each scenario's shared memory carved as on the card;
# and two host-only probes: the fused substep's carve size and the manifold
# cut.
HARNESS = r"""
#include "substep.cuh"
#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>
extern "C" int rs_tables_size() { return (int)sizeof(RsTables); }
static float* scratch(std::vector<double>& buf, int words) {
  buf.assign(words / 2 + 2, 0.0);
  return reinterpret_cast<float*>(buf.data());
}
extern "C" int rs_forward(const void* T, const void*, const float* qpos, const float* qvel, const float* mass,
    const float* inertia, const float* gravity, const float* armature, float* xpos, float* xquat, float* xmat,
    float* gxpos, float* gxmat, float* sxpos, float* sxmat, float* sa, float* sl, float* M, float* bias,
    float* xipos, float* ximat, int B, void*) {
  const RsTables& t = *(const RsTables*)T;
  Fwd s;
  Carver n{nullptr, 0};
  carve_fwd(t, n, s);
  carve_rnea(t, n, s);
  std::vector<double> buf;
  Carver c{scratch(buf, n.w), 0};
  carve_fwd(t, c, s);
  carve_rnea(t, c, s);
  for (int b = 0; b < B; ++b)
    forward_body(HostTeam(), t, s, b, qpos, qvel, mass, inertia, gravity, armature, xpos, xquat, xmat, gxpos,
                 gxmat, sxpos, sxmat, sa, sl, M, bias, xipos, ximat);
  return 0;
}
extern "C" int rs_contact_solve(const float* M, const float* JfT, const float* aref, const float* qfrc,
    const float* qvel, const float* damping, const float* reg3, const float* mu, const float* active,
    float* qvel_out, float* f_out, int B, int nv, int K, int iters, int power_iters, float dt, void*) {
  Solve s;
  float* Msh;
  Carver n{nullptr, 0};
  carve_k2(nv, K, n, Msh, s);
  std::vector<double> buf;
  Carver c{scratch(buf, n.w), 0};
  carve_k2(nv, K, c, Msh, s);
  for (int b = 0; b < B; ++b)
    contact_solve_body(HostTeam(), s, Msh, b, nv, K, iters, power_iters, dt, M, JfT, aref, qfrc, qvel, damping,
                       reg3, mu, active, qvel_out, f_out);
  return 0;
}
extern "C" int rs_substep_smem_bytes(const void* T_host) {
  Sub sh;
  return 4 * carve_substep(*(const RsTables*)T_host, nullptr, sh);
}
template <bool AUX>
static int substep(const void* T, const float* qpos, const float* qvel, const float* mass, const float* inertia,
    const float* gravity, const float* armature, const float* goal, const float* gains, const float* grip,
    float* qpos_out, float* qvel_out, float* f_out, float* sxpos, float* sxmat, float* bxpos, float* pdist,
    int B) {
  const RsTables& t = *(const RsTables*)T;
  Sub sh;
  std::vector<double> buf;
  carve_substep(t, scratch(buf, rs_substep_smem_bytes(T) / 4), sh);
  for (int b = 0; b < B; ++b)
    substep_body<AUX>(HostTeam(), t, sh, b, qpos, qvel, mass, inertia, gravity, armature, goal, gains, grip,
                      qpos_out, qvel_out, f_out, sxpos, sxmat, bxpos, pdist);
  return 0;
}
extern "C" int rs_substep_aux(const void* T, const void*, const float* qpos, const float* qvel,
    const float* mass, const float* inertia, const float* gravity, const float* armature, const float* goal,
    const float* gains, const float* grip, float* qpos_out, float* qvel_out, float* f_out, float* sxpos,
    float* sxmat, float* bxpos, float* pdist, int B, void*) {
  return substep<true>(T, qpos, qvel, mass, inertia, gravity, armature, goal, gains, grip, qpos_out, qvel_out,
                       f_out, sxpos, sxmat, bxpos, pdist, B);
}
extern "C" int rs_substep(const void* T, const void*, const float* qpos, const float* qvel, const float* mass,
    const float* inertia, const float* gravity, const float* armature, const float* goal, const float* gains,
    const float* grip, float* qpos_out, float* qvel_out, float* f_out, int B, void*) {
  return substep<false>(T, qpos, qvel, mass, inertia, gravity, armature, goal, gains, grip, qpos_out, qvel_out,
                        f_out, nullptr, nullptr, nullptr, nullptr, B);
}
extern "C" int rs_fk(const void* T, const float* qpos, float* xpos, float* xquat, int B, void*) {
  for (int b = 0; b < B; ++b) fk_pose_one(*(const RsTables*)T, (size_t)b, qpos, xpos, xquat);
  return 0;
}
extern "C" int rs_s_substep() { return RS_S_SUBSTEP; }
extern "C" int rs_cut(float* d, int nc, int npts, int* cand, float* dist) {
  cut_team(HostTeam(), d, nc, npts, cand, dist);
  return 0;
}
// A team of nt CPU threads: sync is a barrier; the reductions go through a
// shared buffer (argmin as WarpTeam's: the smallest key, then the lowest
// index).
struct TeamShared {
  std::mutex m;
  std::condition_variable cv;
  int n, count = 0, gen = 0;
  std::vector<float> f;
  std::vector<double> d;
  std::vector<int> i;
  explicit TeamShared(int n_) : n(n_), f(n_), d(n_), i(n_) {}
  void wait() {
    std::unique_lock<std::mutex> l(m);
    const int g = gen;
    if (++count == n) { count = 0; ++gen; cv.notify_all(); }
    else cv.wait(l, [&] { return gen != g; });
  }
};
struct ThreadTeam {
  int r;
  TeamShared* sh;
  int rank() const { return r; }
  int size() const { return sh->n; }
  void sync() const { sh->wait(); }
  template <class V> V reduce(std::vector<V>& buf, V v, V (*op)(V, V)) const {
    buf[r] = v; sync();
    V s = buf[0];
    for (int k = 1; k < sh->n; ++k) s = op(s, buf[k]);
    sync();
    return s;
  }
  double sum(double v) const { return reduce<double>(sh->d, v, [](double a, double b) { return a + b; }); }
  float max(float v) const { return reduce<float>(sh->f, v, [](float a, float b) { return fmaxf(a, b); }); }
  unsigned ballot(bool p) const {
    sh->i[r] = p; sync();
    unsigned m = 0;
    for (int k = 0; k < sh->n; ++k) m |= (unsigned)(sh->i[k] != 0) << k;
    sync();
    return m;
  }
  int argmin(float v, int idx) const {
    sh->f[r] = v; sh->i[r] = idx; sync();
    unsigned bk = 0xffffffffu;
    int bi = 0x7fffffff;
    for (int k = 0; k < sh->n; ++k) {
      const unsigned key = rs_fkey(sh->f[k]);
      if (key < bk || (key == bk && sh->i[k] < bi)) { bk = key; bi = sh->i[k]; }
    }
    sync();
    return bi;
  }
};
template <class F> static void on_team(int nt, F body) {
  TeamShared sh(nt);
  std::vector<std::thread> th;
  for (int r = 0; r < nt; ++r) th.emplace_back([&, r] { body(ThreadTeam{r, &sh}); });
  for (auto& t : th) t.join();
}
extern "C" int rs_substep_threads(int nt, int aux, const void* T, const float* qpos, const float* qvel,
    const float* mass, const float* inertia, const float* gravity, const float* armature, const float* goal,
    const float* gains, const float* grip, float* qpos_out, float* qvel_out, float* f_out, float* sxpos,
    float* sxmat, float* bxpos, float* pdist, int B) {
  const RsTables& t = *(const RsTables*)T;
  for (int b = 0; b < B; ++b) {
    std::vector<double> buf;
    float* base = scratch(buf, rs_substep_smem_bytes(T) / 4);
    on_team(nt, [&](const ThreadTeam& tm) {
      Sub sh;
      carve_substep(t, base, sh);
      if (aux)
        substep_body<true>(tm, t, sh, b, qpos, qvel, mass, inertia, gravity, armature, goal, gains, grip, qpos_out,
                           qvel_out, f_out, sxpos, sxmat, bxpos, pdist);
      else
        substep_body<false>(tm, t, sh, b, qpos, qvel, mass, inertia, gravity, armature, goal, gains, grip,
                            qpos_out, qvel_out, f_out, sxpos, sxmat, bxpos, pdist);
    });
  }
  return 0;
}
extern "C" int rs_cut_threads(int nt, float* d, int nc, int npts, int* cand, float* dist) {
  on_team(nt, [&](const ThreadTeam& tm) { cut_team(tm, d, nc, npts, cand, dist); });
  return 0;
}
"""
_V, _I = ctypes.c_void_p, ctypes.c_int
HOST_ONLY = {"rs_s_substep": [], "rs_cut": [_V, _I, _I, _V, _V], "rs_substep_threads": [_I, _I] + [_V] * 17 + [_I],
             "rs_cut_threads": [_I, _V, _I, _I, _V, _V]}
CARD_ONLY = ("rs_substep_resident",)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernels' device code for the CPU")
    d = tmp_path_factory.mktemp("kernels_host")
    src, so = d / "harness.cpp", d / "libharness.so"
    src.write_text(HARNESS)
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-pthread", f"-I{CSRC}", str(src), "-o", str(so)],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    for name, args in {**build._SIGNATURES, **HOST_ONLY}.items():
        if name not in CARD_ONLY:
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = ctypes.c_int
    assert lib.rs_tables_size() == ctypes.sizeof(tables.RsTables)
    return lib


@pytest.fixture(scope="module")
def contact_state():
    """The port's Lift env (CPU) driven until the cube rests and the
    grip site is over it."""
    env = robosuite_tpu_torch.make("Lift", robots="Panda", reward_shaping=True, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(0)
    s, _ = env.reset_batch(4, gen)
    for i in range(6):
        kin = forward.forward_products(env.model, s.physics.qpos, s.physics.qvel)[0]
        a = torch.zeros(4, env.action_dim)
        a[:, :3] = torch.clamp(-env._get_observations(s.physics, kin)["gripper_to_cube_pos"] * 40.0, -1, 1)
        s, _ = env.rollout_batch(s, a)
    return env, s


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


def test_forward_kernel_matches_plain(lib, contact_state):
    env, s = contact_state
    m, B = env.model, 4
    q, qd = s.physics.qpos.contiguous(), s.physics.qvel.contiguous()
    leaves = forward.runtime_leaves(m, B)
    kin, M, bias = forward.forward_plain(m, q, qd, *leaves)
    ref = dict(kin.__dict__, M=M, bias=bias)
    names = ("xpos", "xquat", "xmat", "geom_xpos", "geom_xmat", "site_xpos", "site_xmat", "sdof_ang",
             "sdof_lin", "M", "bias", "xipos", "ximat")
    out = {k: torch.empty_like(ref[k]) for k in names}
    T = tables.pack(m)
    lib.rs_forward(_p(T), _p(T), *(_p(t) for t in (q, qd, *leaves)), *(_p(out[k]) for k in names), B, None)
    for k in names:
        scale = max(1.0, float(ref[k].abs().max())) if k in ("M", "bias") else 1.0
        tol = {"M": 1e-5, "bias": 1e-4}.get(k, 2e-5)
        assert float((out[k] - ref[k]).abs().max()) / scale <= tol, k


def test_contact_solve_kernel_matches_plain(lib, contact_state):
    env, s = contact_state
    m, B = env.model, 4
    q, qd = s.physics.qpos, s.physics.qvel
    kin, M, bias = forward.forward_plain(m, q, qd, *forward.runtime_leaves(m, B))
    ctrl = env.robots[0].run_controllers(kin, M, bias, q, qd, s.ctrl, torch.zeros(B, m.nu))
    qfrc, extra = engine.total_smooth_force(m, q, qd, ctrl, M, bias)
    JfT, aref, reg3, mu, act = C.solver_inputs(m, kin, C.narrowphase(m, kin), qd, m.timestep)
    assert int(act.sum(1).max()) >= 4
    args = [t.contiguous() for t in (M, JfT, aref, qfrc, qd, m.dof_damping + extra, reg3, mu, act)]
    qv_p, f_p = contact_solve.vel_update_plain(*args, C.APGD_ITERS, C.POWER_ITERS, m.timestep)
    qv_k, f_k = torch.empty_like(qv_p), torch.empty_like(f_p)
    lib.rs_contact_solve(*(_p(t) for t in args), _p(qv_k), _p(f_k), B, m.nv, act.shape[1], C.APGD_ITERS,
                         C.POWER_ITERS, m.timestep, None)
    assert float((qv_k - qv_p).abs().max()) <= 1e-4
    assert float((f_k - f_p).abs().max()) <= 1e-4 * max(1.0, float(f_p.abs().max()))


def test_substep_kernel_matches_plain(lib, contact_state):
    env, s = contact_state
    m, B = env.model, 4
    q, qd = s.physics.qpos.contiguous(), s.physics.qvel.contiguous()
    leaves = forward.runtime_leaves(m, B)
    kin = forward.forward_plain(m, q, qd, *leaves)[0]
    robot = env.robots[0]
    goal, gains = env._fused_goal_fn(robot, "right", s.ctrl, kin)
    grip = robot.gripper_ctrl("right", s.ctrl).contiguous()
    qp_p, qv_p, f_p = substep.substep_plain(env, m, q, qd, *leaves, goal, gains, grip)
    qp_k, qv_k, f_k = torch.empty_like(qp_p), torch.empty_like(qv_p), torch.empty_like(f_p)
    T = tables.pack(m, arm=substep.extract_spec(env, m))
    lib.rs_substep(_p(T), _p(T), *(_p(t) for t in (q, qd, *leaves, goal, gains, grip, qp_k, qv_k, f_k)), B, None)
    assert float((qp_k - qp_p).abs().max()) <= 1e-5
    assert float((qv_k - qv_p).abs().max()) <= 1e-3
    np.testing.assert_allclose(f_k.numpy(), f_p.numpy(), rtol=0, atol=1e-4 * max(1.0, float(f_p.abs().max())))


def test_fk_kernel_matches_plain(lib, contact_state):
    """K4 at an odd batch (the kernel masks the ragged last block)."""
    env, s = contact_state
    m = env.model
    rng = np.random.default_rng(0)
    q = s.physics.qpos.repeat(5, 1)[:7].contiguous()
    q[:, :9] += torch.as_tensor(rng.uniform(-0.3, 0.3, (7, 9)), dtype=torch.float32)
    xpos_p, xquat_p = fk.fk_pose_plain(m, q)
    xpos_k, xquat_k = torch.empty_like(xpos_p), torch.empty_like(xquat_p)
    T = tables.pack(m)
    lib.rs_fk(_p(T), _p(q), _p(xpos_k), _p(xquat_k), 7, None)
    assert float((xpos_k - xpos_p).abs().max()) <= 2e-5
    assert float((xquat_k - xquat_p).abs().max()) <= 2e-5


def test_substep_aux_kernel_matches_plain(lib, contact_state):
    """K3's emit_aux variant on the 2-point planning model (dt 25 ms, 10
    solver iterations): the substep, the post-step poses and the per-pair
    minimum distances."""
    env, s = contact_state
    m = env.model.replace(timestep=0.025, solver_iters=10, pair_points_cap=2)
    B = 4
    q, qd = s.physics.qpos.contiguous(), s.physics.qvel.contiguous()
    leaves = forward.runtime_leaves(m, B)
    kin = forward.forward_plain(m, q, qd, *leaves)[0]
    robot = env.robots[0]
    goal, gains = env._fused_goal_fn(robot, "right", s.ctrl, kin)
    grip = robot.gripper_ctrl("right", s.ctrl).contiguous()
    ref = substep.substep_aux_plain(env, m, q, qd, *leaves, goal, gains, grip)
    out = [torch.empty_like(r) for r in ref]
    T = tables.pack(m, arm=substep.extract_spec(env, m))
    lib.rs_substep_aux(_p(T), _p(T), *(_p(t) for t in (q, qd, *leaves, goal, gains, grip, *out)), B, None)
    names = ("qpos", "qvel", "f", "site_xpos", "site_xmat", "xpos", "pair_dist")
    tols = dict(qpos=1e-5, qvel=1e-3, site_xpos=2e-5, site_xmat=2e-5, xpos=2e-5, pair_dist=1e-5)
    for name, k, p in zip(names, out, ref):
        if name in tols:
            assert float((k - p).abs().max()) <= tols[name], name
    assert float(ref[-1].min()) < 0.0  # some pair touches


@pytest.fixture(scope="module")
def stack_state():
    """The port's Stack env with the JOINT_POSITION arm (CPU) after a reset
    and 4 policy steps (the cubes have landed), the arm moving."""
    env = robosuite_tpu_torch.make("Stack", robots="Panda", controller_configs="JOINT_POSITION",
                                   reward_shaping=True, device="cpu")
    gen = torch.Generator().manual_seed(0)
    s, _ = env.reset_batch(3, gen)
    a = 0.5 * torch.randn(3, env.action_dim, generator=gen)
    for _ in range(4):
        s, _ = env.rollout_batch(s, a)
    return env, s


def _jp_inputs(env, m, s):
    q, qd = s.physics.qpos.contiguous(), s.physics.qvel.contiguous()
    leaves = forward.runtime_leaves(m, q.shape[0])
    kin = forward.forward_plain(m, q, qd, *leaves)[0]
    robot = env.robots[0]
    goal, gains = env._fused_goal_fn(robot, "right", s.ctrl, kin)
    assert goal.shape == (q.shape[0], 7) and gains.shape == (q.shape[0], 14)
    return (q, qd, *leaves, goal, gains, robot.gripper_ctrl("right", s.ctrl).contiguous())


@pytest.mark.parametrize("emit_aux", [False, True], ids=["K3-JP", "K3-aux-JP"])
def test_joint_position_substep_kernel_matches_plain(lib, stack_state, emit_aux):
    """K3's JOINT_POSITION branch on the Stack world, without emit_aux on
    the execution model and with it on the planning model (dt 25 ms, 10
    solver iterations, all 96 rows). The pair distances are held as
    chip_smoke.py holds them: a box-box pair whose SAT edge test ties within
    float rounding (the cubes' faces parallel to the pedestal's and each
    other's) may keep its edge candidate in one version only, and is set
    aside only with chip_smoke.hold_pair_dist's float64 witness of the tie."""
    env, s = stack_state
    m = env.model.replace(timestep=0.025, solver_iters=10) if emit_aux else env.model
    args = _jp_inputs(env, m, s)
    ref = (substep.substep_aux_plain if emit_aux else substep.substep_plain)(env, m, *args)
    assert ref[2].shape == (3, 288)
    out = [torch.empty_like(r) for r in ref]
    T = tables.pack(m, arm=substep.extract_spec(env, m))
    if emit_aux:
        lib.rs_substep_aux(_p(T), _p(T), *(_p(t) for t in (*args, *out)), 3, None)
    else:
        lib.rs_substep(_p(T), _p(T), *(_p(t) for t in (*args, *out)), 3, None)
    names = ("qpos", "qvel", "f", "site_xpos", "site_xmat", "xpos")
    tols = dict(qpos=1e-5, qvel=1e-3, site_xpos=2e-5, site_xmat=2e-5, xpos=2e-5)
    for name, k, p in zip(names, out, ref):
        if name in tols:
            assert float((k - p).abs().max()) <= tols[name], name
    if emit_aux:  # pair distances in every scenario, witnessed box-box SAT near-ties set aside
        import chip_smoke

        assert chip_smoke.hold_pair_dist("K3-aux-JP", m, out[-1], ref[-1], out[0], ref[0], tol=1e-5) <= 1e-5
    f_scale = max(1.0, float(ref[2].abs().max()))
    assert float((out[2] - ref[2]).abs().max()) <= 1e-4 * f_scale


def test_contact_solve_kernel_matches_plain_on_stack(lib, stack_state):
    """K2 at Stack's width (nv 21, 96 rows) on the plain path's operands."""
    env, s = stack_state
    m, B = env.model, 3
    q, qd = s.physics.qpos, s.physics.qvel
    kin, M, bias = forward.forward_plain(m, q, qd, *forward.runtime_leaves(m, B))
    ctrl = env.robots[0].run_controllers(kin, M, bias, q, qd, s.ctrl, torch.zeros(B, m.nu))
    qfrc, extra = engine.total_smooth_force(m, q, qd, ctrl, M, bias)
    JfT, aref, reg3, mu, act = C.solver_inputs(m, kin, C.narrowphase(m, kin), qd, m.timestep)
    assert act.shape[1] == 96 and int(act.sum(1).min()) >= 4  # both cubes on the table
    args = [t.contiguous() for t in (M, JfT, aref, qfrc, qd, m.dof_damping + extra, reg3, mu, act)]
    qv_p, f_p = contact_solve.vel_update_plain(*args, C.APGD_ITERS, C.POWER_ITERS, m.timestep)
    qv_k, f_k = torch.empty_like(qv_p), torch.empty_like(f_p)
    lib.rs_contact_solve(*(_p(t) for t in args), _p(qv_k), _p(f_k), B, m.nv, 96, C.APGD_ITERS, C.POWER_ITERS,
                         m.timestep, None)
    assert float((qv_k - qv_p).abs().max()) <= 1e-4
    assert float((f_k - f_p).abs().max()) <= 1e-4 * max(1.0, float(f_p.abs().max()))


def _models():
    """Lift (OSC) and Stack (JOINT_POSITION) with their planning models, and
    each one's fused-substep arm spec."""
    out = []
    for name, kw in (("Lift", {}), ("Stack", dict(controller_configs="JOINT_POSITION"))):
        env = robosuite_tpu_torch.make(name, robots="Panda", reward_shaping=True, device="cpu", **kw)
        plan = env.model.replace(timestep=0.025, solver_iters=10, **({"pair_points_cap": 2} if name == "Lift" else {}))
        out += [(f"{name}", env, env.model), (f"{name} planning", env, plan)]
    return out


def test_substep_carve_matches_mirror(lib):
    """The fused substep's shared memory per scenario: the C carve and
    ops/tables.py's mirror agree, Lift's (OSC) sits below Stack's, the
    2-point planning model below the execution model, and a block fits the
    card's 227 KB at the library's scenarios per block (RS_S_SUBSTEP) and
    at every value the sweep of ab_kernels.py builds."""
    sizes = {}
    for label, env, m in _models():
        t = tables.fill(m, arm=substep.extract_spec(env, m))
        c_bytes = lib.rs_substep_smem_bytes(ctypes.addressof(t))
        assert c_bytes == tables.substep_smem_bytes(t), label
        assert max(lib.rs_s_substep(), *ab_kernels.SWEEP) * c_bytes <= 232448, label
        sizes[label] = c_bytes
    assert sizes["Lift planning"] < sizes["Lift"] < sizes["Stack"]
    assert sizes["Stack planning"] <= sizes["Stack"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_manifold_cut_keeps_earliest_on_ties(lib, seed):
    """The cut (csrc/narrowphase.cuh cut_team over the host team, whose
    team argmin keeps the lowest index) against contact.select_deepest's
    stable sort, on depths with many ties, -0.0 beside 0.0 included."""
    rng = np.random.default_rng(seed)
    for nc, npts in ((25, 4), (25, 8), (8, 4), (2, 2)):
        d = rng.integers(-3, 3, nc).astype(np.float32) * 0.5
        d[rng.random(nc) < 0.2] = -0.0
        ref = C.select_deepest(torch.as_tensor(d), npts).numpy()
        work = d.copy()
        cand, dist = np.zeros(npts, dtype=np.int32), np.zeros(npts, dtype=np.float32)
        lib.rs_cut(work.ctypes.data, nc, npts, cand.ctypes.data, dist.ctypes.data)
        np.testing.assert_array_equal(cand, ref if nc > npts else np.arange(npts))
        np.testing.assert_array_equal(dist, d[cand])


@pytest.mark.parametrize("world", ["Lift K3", "Stack K3-aux-JP"])
def test_substep_over_a_thread_team_matches_one_lane(lib, contact_state, stack_state, world):
    """K3 over a 32-lane team of CPU threads (the lanes split every stage as
    the card's warp does; the solve's compaction runs through the team
    ballot): the same outputs as the one-lane team (the solve's sums do not
    depend on how the lanes split the work) and the plain version's, at the
    tolerances above."""
    if world == "Lift K3":
        env, s = contact_state
        m, aux = env.model, False
        q, qd = s.physics.qpos.contiguous(), s.physics.qvel.contiguous()
        leaves = forward.runtime_leaves(m, q.shape[0])
        kin = forward.forward_plain(m, q, qd, *leaves)[0]
        robot = env.robots[0]
        goal, gains = env._fused_goal_fn(robot, "right", s.ctrl, kin)
        args = (q, qd, *leaves, goal, gains, robot.gripper_ctrl("right", s.ctrl).contiguous())
    else:
        env, s = stack_state
        m, aux = env.model.replace(timestep=0.025, solver_iters=10), True
        args = _jp_inputs(env, m, s)
    B = args[0].shape[0]
    ref = (substep.substep_aux_plain if aux else substep.substep_plain)(env, m, *args)[:3]
    T = tables.pack(m, arm=substep.extract_spec(env, m))
    outs = {}
    for nt in (1, 32):
        out = [torch.empty_like(r) for r in ref]
        aux_out = ([torch.empty(B, m.nsite, 3), torch.empty(B, m.nsite, 3, 3), torch.empty(B, m.nbody, 3),
                    torch.empty(B, m.npair)] if aux else [None] * 4)
        lib.rs_substep_threads(nt, int(aux), _p(T), *(_p(t) for t in args), *(_p(t) for t in out),
                               *((_p(t) if t is not None else None) for t in aux_out), B)
        outs[nt] = out
    for name, tol, k32, k1, p in zip(("qpos", "qvel", "f"), (1e-5, 1e-3, 1e-4), outs[32], outs[1], ref):
        scale = max(1.0, float(p.abs().max())) if name == "f" else 1.0
        assert float((k32 - p).abs().max()) <= tol * scale, name
        assert float((k32 - k1).abs().max()) <= 1e-6 * scale, name


@pytest.mark.parametrize("nt", [5, 32])
def test_manifold_cut_over_a_thread_team_keeps_earliest_on_ties(lib, nt):
    """The cut over a team of nt CPU threads (each lane scans its strided
    share, the team argmin keeps the lowest index) against
    contact.select_deepest's stable sort, on depths with many ties."""
    rng = np.random.default_rng(nt)
    for nc, npts in ((25, 4), (25, 8), (8, 4), (40, 6)):
        d = rng.integers(-3, 3, nc).astype(np.float32) * 0.5
        d[rng.random(nc) < 0.2] = -0.0
        ref = C.select_deepest(torch.as_tensor(d), npts).numpy()
        work = d.copy()
        cand, dist = np.zeros(npts, dtype=np.int32), np.zeros(npts, dtype=np.float32)
        lib.rs_cut_threads(nt, work.ctypes.data, nc, npts, cand.ctypes.data, dist.ctypes.data)
        np.testing.assert_array_equal(cand, ref)
        np.testing.assert_array_equal(dist, d[cand])
