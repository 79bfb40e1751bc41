"""The CUDA kernels' arithmetic, checked without a GPU: the device code in
robosuite_tpu_torch/csrc/*.cuh is written as functions over a team of
lanes that also compile as plain C++ over the one-lane host team
(csrc/common.cuh HostTeam), so this test builds it with the host C++
compiler and runs K1, K2, K3, K3's emit_aux variant and K4 on CPU tensors,
each in shared-memory carves as on the card (K1 and K4 several scenarios
a block, their inputs staged and their outputs stored as the block's
spans), and holds each against its plain PyTorch version with the
tolerances chip_smoke.py uses on the card; on the Lift world (OSC) and on
the Stack world (JOINT_POSITION: K2, K3-JP and K3-aux-JP at nv 21, 96
rows, which also exercises the kernels' compile-time maxima and
sizeof(RsTables)).
It also holds the fused substep's carve size (C) to the card's limits, the
table's (body, dof) pair lists to the model's ancestor mask, K1's stride-0
leaves to contiguous ones, the split tree walk to the serial walk bit for
bit, and the manifold cut's tie rule to contact.select_deepest; and runs
K1, K3 and the cut over a team of CPU threads (ThreadTeam below: rank,
size, a barrier for sync, sums, ballot and argmin through a shared
buffer), so the lane-strided loops, the active-row compaction and the team
argmin run with 32 lanes as on the card. Launch configuration, warp
shuffles and shared memory are exercised only on the card."""

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
from tests.test_torch_door import one_thread  # noqa: F401  (an autouse fixture: one torch thread)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "robosuite_tpu_torch", "csrc")

# The kernel library's C entry points, run over the one-lane host team,
# shared memory carved as on the card; K1 and K3 also over a team of CPU
# threads; the serial reference walk; and the manifold cut.
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
// K1 as the card runs it, S scenarios a block: the block's inputs staged,
// each scenario's forward pass and frames over a team of nt lanes (the
// one-lane host team, or nt CPU threads), the block's output spans stored.
extern "C" int rs_forward_tab(const void* T_host, float* out) {
  return forward_tab_image(*(const RsTables*)T_host, out);
}
static int forward_blocks(int nt, int S, const void* T, const float* tab, const float* qpos, const float* qvel,
    const float* mass, int mbs, const float* inertia, int ibs, const float* gravity, int gbs, const float* armature,
    int abs_, float* out, int B) {
  const RsTables& t = *(const RsTables*)T;
  const K1Io io{qpos, qvel, mass, inertia, gravity, armature, mbs, ibs, gbs, abs_, out};
  FwdTab F;
  Fwd f0;
  Frames fr0;
  std::vector<double> buf;
  float* base = scratch(buf, carve_k1(t, nullptr, S, 0, F, f0, fr0));
  carve_k1(t, base, S, 0, F, f0, fr0);
  const int tw = (int)(f0.q - base);
  load_rows(HostTeam(), base, tw, tab, tw, tw, 1);
  for (int b0 = 0; b0 < B; b0 += S) {
    const int nS = B - b0 < S ? B - b0 : S;
    k1_load(HostTeam(), F, f0, (size_t)b0, nS, io);
    for (int pass = 0; pass < 2; ++pass) {  // the frames take the place of every scenario's scratch
      for (int s = 0; s < nS; ++s) {
        Fwd f;
        Frames fr;
        carve_k1(t, base, S, s, F, f, fr);
        if (nt == 1) {
          if (pass == 0) forward_team(HostTeam(), F, f);
          else frames_team(HostTeam(), F, f, fr);
        } else {
          on_team(nt, [&](const ThreadTeam& tm) {
            if (pass == 0) forward_team(tm, F, f);
            else frames_team(tm, F, f, fr);
          });
        }
      }
    }
    k1_store(HostTeam(), F, f0, fr0, (size_t)b0, nS, (size_t)B, out);
  }
  return 0;
}
extern "C" int rs_forward(const void* T, const void*, const float* tab, const float* qpos, const float* qvel,
    const float* mass, int mbs, const float* inertia, int ibs, const float* gravity, int gbs, const float* armature,
    int abs_, float* out, int B, void*) {
  return forward_blocks(1, 3, T, tab, qpos, qvel, mass, mbs, inertia, ibs, gravity, gbs, armature, abs_, out, B);
}
extern "C" int rs_forward_threads(int nt, int S, const void* T, const float* tab, const float* qpos,
    const float* qvel, const float* mass, int mbs, const float* inertia, int ibs, const float* gravity, int gbs,
    const float* armature, int abs_, float* out, int B) {
  return forward_blocks(nt, S, T, tab, qpos, qvel, mass, mbs, inertia, ibs, gravity, gbs, armature, abs_, out, B);
}
extern "C" int rs_contact_solve(const float* M, const float* JfT, const float* aref, const float* qfrc,
    const float* qvel, const float* damping, const float* reg3, const float* mu, const float* active,
    float* qvel_out, float* f_out, int B, int nv, int K, int ne, int iters, int power_iters, float dt, void*) {
  Solve s;
  float* Msh;
  Carver n{nullptr, 0};
  carve_k2(nv, K, ne, n, Msh, s);
  std::vector<double> buf;
  Carver c{scratch(buf, n.w), 0};
  carve_k2(nv, K, ne, c, Msh, s);
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
// K4 as the card runs it, S scenarios a block (one thread each, here one
// after another), the block's rows staged scenario-minor.
extern "C" int rs_fk_blocks(int S, const void* T, const float* tab, const float* qpos, float* out, int B) {
  const RsTables& t = *(const RsTables*)T;
  std::vector<double> buf;
  float* sm = scratch(buf, fk_block_words(t, S));
  const size_t nxp = (size_t)B * 3 * t.nbody;
  for (int b0 = 0; b0 < B; b0 += S)
    fk_block(HostTeam(), t, tab, sm, S, (size_t)b0, B - b0 < S ? B - b0 : S, qpos, out, out + (nxp + 3) / 4 * 4);
  return 0;
}
extern "C" int rs_fk(const void* T, const void*, const float* tab, const float* qpos, float* out, int B, void*) {
  return rs_fk_blocks(5, T, tab, qpos, out, B);
}
// The tree walk as one serial loop (the walk of the kernels before the
// joint terms came off the chain), kept here as the reference the split
// walk must match bit for bit.
template <bool SUB>
RS_DEV void fk_walk_pr4(const RsTables& T, const float* q, float (*xpos)[3], float (*xquat)[4], float (*sa)[3],
                    float (*sl)[3]) {
  xpos[0][0] = xpos[0][1] = xpos[0][2] = 0.0f;
  xquat[0][0] = 1.0f;
  xquat[0][1] = xquat[0][2] = xquat[0][3] = 0.0f;
  for (int b = 1; b < T.nbody; ++b) {
    int p = T.body_parent[b];
    float pos[3], quat[4], tmp[3];
    quat_rot(xquat[p], T.body_pos[b], tmp);
    for (int i = 0; i < 3; ++i) pos[i] = xpos[p][i] + tmp[i];
    quat_mul(xquat[p], T.body_quat[b], quat);
    for (int j = T.body_jntadr[b]; j < T.body_jntadr[b] + T.body_jntnum[b]; ++j) {
      int qa = T.jnt_qposadr[j], da = T.jnt_dofadr[j];
      int jt = T.jnt_type[j];
      if (jt == RS_FREE) {
        for (int i = 0; i < 3; ++i) pos[i] = q[qa + i];
        float n = sqrtf(q[qa + 3] * q[qa + 3] + q[qa + 4] * q[qa + 4] + q[qa + 5] * q[qa + 5] +
                        q[qa + 6] * q[qa + 6]);
        float inv = 1.0f / fmaxf(n, 1e-8f);
        for (int i = 0; i < 4; ++i) quat[i] = q[qa + 3 + i] * inv;
        if constexpr (SUB) {
          float R[9];
          quat2mat(quat, R);
          for (int i = 0; i < 3; ++i) {
            for (int k = 0; k < 3; ++k) {
              sa[da + i][k] = 0.0f;
              sl[da + i][k] = (i == k) ? 1.0f : 0.0f;
            }
            float a[3] = {R[0 * 3 + i], R[1 * 3 + i], R[2 * 3 + i]};
            for (int k = 0; k < 3; ++k) sa[da + 3 + i][k] = a[k];
            v3_cross(pos, a, sl[da + 3 + i]);
          }
        }
      } else if (jt == RS_BALL) {
        float anchor[3], nq[4], lq[4];
        quat_rot(quat, T.jnt_pos[j], tmp);
        for (int i = 0; i < 3; ++i) anchor[i] = pos[i] + tmp[i];
        float n = sqrtf(q[qa] * q[qa] + q[qa + 1] * q[qa + 1] + q[qa + 2] * q[qa + 2] + q[qa + 3] * q[qa + 3]);
        float inv = 1.0f / fmaxf(n, 1e-8f);
        for (int i = 0; i < 4; ++i) lq[i] = q[qa + i] * inv;
        quat_mul(quat, lq, nq);
        for (int i = 0; i < 4; ++i) quat[i] = nq[i];
        quat_rot(quat, T.jnt_pos[j], tmp);
        for (int i = 0; i < 3; ++i) pos[i] = anchor[i] - tmp[i];
        if constexpr (SUB) {
          float R[9];
          quat2mat(quat, R);
          for (int i = 0; i < 3; ++i) {
            float a[3] = {R[0 * 3 + i], R[1 * 3 + i], R[2 * 3 + i]};
            for (int k = 0; k < 3; ++k) sa[da + i][k] = a[k];
            v3_cross(anchor, a, sl[da + i]);
          }
        }
      } else if (jt == RS_SLIDE) {
        float axis[3];
        quat_rot(quat, T.jnt_axis[j], axis);
        float amt = q[qa] - T.qpos0[qa];
        for (int i = 0; i < 3; ++i) pos[i] += axis[i] * amt;
        if constexpr (SUB) {
          for (int i = 0; i < 3; ++i) {
            sa[da][i] = 0.0f;
            sl[da][i] = axis[i];
          }
        }
      } else {  // hinge
        float axis[3], anchor[3], lq[4], nq[4];
        quat_rot(quat, T.jnt_axis[j], axis);
        quat_rot(quat, T.jnt_pos[j], tmp);
        for (int i = 0; i < 3; ++i) anchor[i] = pos[i] + tmp[i];
        float half = 0.5f * (q[qa] - T.qpos0[qa]);
        float c = cosf(half), sn = sinf(half);
        lq[0] = c;
        for (int i = 0; i < 3; ++i) lq[1 + i] = sn * T.jnt_axis[j][i];
        quat_mul(quat, lq, nq);
        for (int i = 0; i < 4; ++i) quat[i] = nq[i];
        quat_rot(quat, T.jnt_pos[j], tmp);
        for (int i = 0; i < 3; ++i) pos[i] = anchor[i] - tmp[i];
        if constexpr (SUB) {
          for (int i = 0; i < 3; ++i) sa[da][i] = axis[i];
          v3_cross(anchor, axis, sl[da]);
        }
      }
    }
    for (int i = 0; i < 3; ++i) xpos[b][i] = pos[i];
    for (int i = 0; i < 4; ++i) xquat[b][i] = quat[i];
  }
}

// Poses and motion subspace of B scenarios by the split walk (old = 0:
// joint_terms, then fk_walk) or by the serial reference (old = 1).
extern "C" int rs_walk(int old, const void* T, const float* qpos, float* xpos, float* xquat, float* sa, float* sl,
    int B) {
  const RsTables& t = *(const RsTables*)T;
  float jl[RS_MAXJ][4];
  for (int b = 0; b < B; ++b) {
    const float* q = qpos + (size_t)b * t.nq;
    float(*xp)[3] = reinterpret_cast<float(*)[3]>(xpos + (size_t)b * 3 * t.nbody);
    float(*xq)[4] = reinterpret_cast<float(*)[4]>(xquat + (size_t)b * 4 * t.nbody);
    float(*a)[3] = reinterpret_cast<float(*)[3]>(sa + (size_t)b * 3 * t.nv);
    float(*l)[3] = reinterpret_cast<float(*)[3]>(sl + (size_t)b * 3 * t.nv);
    if (old) {
      fk_walk_pr4<true>(t, q, xp, xq, a, l);
    } else {
      for (int j = 0; j < t.njnt; ++j) joint_terms(t, j, q, 1, jl[j], 1);
      fk_walk<true>(t, q, 1, &jl[0][0], 1, &xp[0][0], &xq[0][0], 1, a, l);
    }
  }
  return 0;
}
extern "C" int rs_s_substep() { return RS_S_SUBSTEP; }
extern "C" int rs_cut(float* d, int nc, int npts, int* cand, float* dist) {
  cut_team(HostTeam(), d, nc, npts, cand, dist);
  return 0;
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
HOST_ONLY = {"rs_forward_threads": [_I, _I] + [_V] * 5 + [_I, _V] * 3 + [_I, _V, _I],
             "rs_fk_blocks": [_I] + [_V] * 4 + [_I], "rs_walk": [_I] + [_V] * 6 + [_I], "rs_s_substep": [],
             "rs_cut": [_V, _I, _I, _V, _V], "rs_substep_threads": [_I, _I] + [_V] * 17 + [_I],
             "rs_cut_threads": [_I, _V, _I, _I, _V, _V]}
CARD_ONLY = ("rs_substep_resident", "rs_forward_smem_bytes", "rs_fk_smem_bytes", "rs_contact_solve_smem_bytes",
             "rs_forward_scenarios", "rs_contact_solve_scenarios", "rs_smem_limit")


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


K1_TOLS = {"M": 1e-5, "bias": 1e-4}  # relative to max(1, max |plain|); poses 2e-5 (chip_smoke.py's)


def _k1_leaves(m, B, stride0):
    """The model's leaves for B scenarios: stride-0 views or contiguous copies."""
    return forward.model_leaves(m, B) if stride0 else forward.runtime_leaves(m, B)


def _k1_args(leaves):
    """(pointer, batch stride) of each leaf, as the wrapper passes them."""
    args = []
    for t in leaves:
        args += [_p(t), t.stride(0)]
    return args


def _k1_outputs(m, B, out):
    """{name: view} of K1's one allocation, as the wrapper splits it."""
    views, _ = forward.out_views(forward.out_shapes(m, B))
    return {name: out[off:off + n].view(shape) for name, off, n, shape in views}


def _image(lib, T):
    """The model image K1 and K4 stage (csrc/forward.cuh carve_tab), as the
    wrapper builds it."""
    img = torch.empty(lib.rs_forward_tab(_p(T), None), dtype=torch.float32)
    lib.rs_forward_tab(_p(T), _p(img))
    return img


def _k1_run(lib, m, q, qd, leaves, nt=None, S=3):
    """K1's device code on the host (one lane, or a team of nt CPU threads,
    S scenarios a block) -> {output: tensor}."""
    B = q.shape[0]
    out = torch.full((forward.out_views(forward.out_shapes(m, B))[1],), float("nan"))
    T = tables.pack(m)
    img = _image(lib, T)
    if nt is None:
        lib.rs_forward(_p(T), _p(T), _p(img), _p(q), _p(qd), *_k1_args(leaves), _p(out), B, None)
    else:
        lib.rs_forward_threads(nt, S, _p(T), _p(img), _p(q), _p(qd), *_k1_args(leaves), _p(out), B)
    return _k1_outputs(m, B, out)


def _hold_k1(out, m, q, qd):
    kin, M, bias = forward.forward_plain(m, q, qd, *forward.model_leaves(m, q.shape[0]))
    ref = dict(kin.__dict__, M=M, bias=bias)
    for k in forward.OUTPUTS:
        scale = max(1.0, float(ref[k].abs().max())) if k in K1_TOLS else 1.0
        assert float((out[k] - ref[k]).abs().max()) / scale <= K1_TOLS.get(k, 2e-5), k


def test_forward_kernel_matches_plain(lib, contact_state):
    """K1 (one lane, 3 scenarios a block, so the 4 scenarios end in a ragged
    block) against the plain version, the model's leaves at batch stride 0."""
    env, s = contact_state
    m = env.model
    q, qd = s.physics.qpos.contiguous(), s.physics.qvel.contiguous()
    _hold_k1(_k1_run(lib, m, q, qd, _k1_leaves(m, 4, True)), m, q, qd)


@pytest.mark.parametrize("world", ["Lift", "Stack"])
def test_forward_stride0_leaves_match_contiguous(lib, contact_state, stack_state, world):
    """Leaves of batch stride 0 (the model's own, expanded) and contiguous
    copies of them give the same outputs, bit for bit; and leaves that
    differ per scenario reach their own scenario."""
    env, s = contact_state if world == "Lift" else stack_state
    m = env.model
    q, qd = s.physics.qpos.contiguous(), s.physics.qvel.contiguous()
    B = q.shape[0]
    a = _k1_run(lib, m, q, qd, _k1_leaves(m, B, True))
    b = _k1_run(lib, m, q, qd, _k1_leaves(m, B, False))
    for k in forward.OUTPUTS:
        assert torch.equal(a[k], b[k]), k
    leaves = list(_k1_leaves(m, B, False))
    scale = torch.linspace(0.5, 1.5, B)
    leaves[0] = leaves[0] * scale[:, None]  # per-scenario masses
    leaves[2] = leaves[2] * scale[:, None]  # and gravity
    out = _k1_run(lib, m, q, qd, leaves)
    kin, M, bias = forward.forward_plain(m, q, qd, *leaves)
    assert float((out["M"] - M).abs().max()) <= 1e-5 * max(1.0, float(M.abs().max()))
    assert float((out["bias"] - bias).abs().max()) <= 1e-4 * max(1.0, float(bias.abs().max()))


@pytest.mark.parametrize("world", ["Lift", "Stack"])
def test_forward_over_a_thread_team_matches_one_lane(lib, contact_state, stack_state, world):
    """K1 over a team of 32 CPU threads (the card's one-warp team), 2
    scenarios a block: the walk's joint terms one joint a lane, CRBA's pairs
    spread over the lanes, every sum in the pair list's fixed order, so the
    outputs equal the one-lane run's bit for bit; and the plain version's at
    chip_smoke.py's tolerances."""
    env, s = contact_state if world == "Lift" else stack_state
    m = env.model
    q, qd = s.physics.qpos.contiguous(), s.physics.qvel.contiguous()
    leaves = _k1_leaves(m, q.shape[0], True)
    one = _k1_run(lib, m, q, qd, leaves)
    team = _k1_run(lib, m, q, qd, leaves, nt=32, S=2)
    for k in forward.OUTPUTS:
        assert torch.equal(team[k], one[k]), k
    _hold_k1(team, m, q, qd)


@pytest.mark.parametrize("world", ["Lift", "Stack"])
def test_split_walk_equals_serial_walk(lib, contact_state, stack_state, world):
    """The walk with its joint terms off the chain gives the poses and the
    motion subspace of the serial walk bit for bit (so the fused substep's
    contact decisions, which read those poses, do not move), at the
    env's states and at random joint angles."""
    env, s = contact_state if world == "Lift" else stack_state
    m = env.model
    rng = np.random.default_rng(3)
    q = s.physics.qpos.repeat(4, 1).contiguous()
    q[:, :9] += torch.as_tensor(rng.uniform(-1.0, 1.0, (q.shape[0], 9)), dtype=torch.float32)
    B, T = q.shape[0], tables.pack(m)
    runs = []
    for old in (0, 1):
        o = [torch.zeros(B, m.nbody, 3), torch.zeros(B, m.nbody, 4), torch.zeros(B, m.nv, 3), torch.zeros(B, m.nv, 3)]
        lib.rs_walk(old, _p(T), _p(q), *(_p(t) for t in o), B)
        runs.append(o)
    for new, old in zip(*runs):
        assert torch.equal(new, old)
    assert float((runs[0][0] - fk.fk_pose_plain(m, q)[0]).abs().max()) <= 2e-5


@pytest.mark.parametrize("world", ["Lift", "Stack"])
def test_pair_lists_match_ancestor_mask(world):
    """The (body, dof) pair lists in the packed table hold exactly the
    nonzero entries of model.ancestor_mask: dof-major by dof then body,
    body-major by body then dof, each run starting where its prefix says;
    and each mass-matrix entry's source (m_rc) is the (row, col) with
    body(col) moved by dof row, or none."""
    kw = {} if world == "Lift" else dict(controller_configs="JOINT_POSITION")
    m = robosuite_tpu_torch.make(world, robots="Panda", reward_shaping=True, device="cpu", **kw).model
    anc = m.ancestor_mask.numpy() != 0
    t = tables.fill(m)
    n = t.npr
    assert n == int(anc.sum())
    db = np.ctypeslib.as_array(t.pr_db)[:n]
    bd = np.ctypeslib.as_array(t.pr_bd)[:n]
    dof0 = np.ctypeslib.as_array(t.dof_pr0)[:m.nv + 1]
    body0 = np.ctypeslib.as_array(t.body_pr0)[:m.nbody + 1]
    want_db = [(b, d) for d in range(m.nv) for b in range(m.nbody) if anc[b, d]]
    assert [(e >> 8, e & 255) for e in db] == want_db
    for d in range(m.nv):
        assert [e & 255 for e in db[dof0[d]:dof0[d + 1]]] == [d] * int(anc[:, d].sum())
    for b in range(m.nbody):
        assert list(bd[body0[b]:body0[b + 1]]) == [d for d in range(m.nv) if anc[b, d]]
    assert dof0[-1] == body0[-1] == n
    # each M entry's source: dof `row` moves body(col), the entry or its mirror
    m_rc = np.ctypeslib.as_array(t.m_rc)[:m.nv * m.nv].reshape(m.nv, m.nv)
    for e in range(m.nv):
        for d in range(m.nv):
            row, col = divmod(int(m_rc[e, d]), 256) if m_rc[e, d] >= 0 else (-1, -1)
            if anc[m.dof_bodyid[d], e] or anc[m.dof_bodyid[e], d]:
                assert {row, col} == {e, d} and anc[m.dof_bodyid[col], row]
            else:
                assert m_rc[e, d] == -1


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
    lib.rs_contact_solve(*(_p(t) for t in args), _p(qv_k), _p(f_k), B, m.nv, act.shape[1], 0, C.APGD_ITERS,
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


def _fk_run(lib, m, q, S=None):
    B = q.shape[0]
    at = -(-B * m.nbody * 3 // 4) * 4
    out = torch.full((at + B * m.nbody * 4,), float("nan"))
    T = tables.pack(m)
    img = _image(lib, T)
    if S is None:
        lib.rs_fk(_p(T), _p(T), _p(img), _p(q), _p(out), B, None)
    else:
        lib.rs_fk_blocks(S, _p(T), _p(img), _p(q), _p(out), B)
    return out[:B * m.nbody * 3].view(B, m.nbody, 3), out[at:].view(B, m.nbody, 4)


def test_fk_kernel_matches_plain(lib, contact_state):
    """K4 at an odd batch (5 scenarios a block here, so the last is ragged)."""
    env, s = contact_state
    m = env.model
    rng = np.random.default_rng(0)
    q = s.physics.qpos.repeat(5, 1)[:7].contiguous()
    q[:, :9] += torch.as_tensor(rng.uniform(-0.3, 0.3, (7, 9)), dtype=torch.float32)
    xpos_p, xquat_p = fk.fk_pose_plain(m, q)
    xpos_k, xquat_k = _fk_run(lib, m, q)
    assert float((xpos_k - xpos_p).abs().max()) <= 2e-5
    assert float((xquat_k - xquat_p).abs().max()) <= 2e-5


@pytest.mark.parametrize("world", ["Lift", "Stack"])
def test_fk_staged_block_matches_plain(lib, contact_state, stack_state, world):
    """K4's block as the card runs it, 64 scenarios a block over 150
    scenarios (two full blocks and a ragged one): qpos staged
    scenario-minor, the walk over the staged rows, the spans stored; the
    same poses as one scenario a block, and the plain version's at 2e-5."""
    env, s = contact_state if world == "Lift" else stack_state
    m = env.model
    rng = np.random.default_rng(1)
    q = s.physics.qpos.repeat(-(-150 // s.physics.qpos.shape[0]), 1)[:150].contiguous()
    q[:, :9] += torch.as_tensor(rng.uniform(-0.5, 0.5, (150, 9)), dtype=torch.float32)
    xpos_k, xquat_k = _fk_run(lib, m, q, S=64)
    xpos_1, xquat_1 = _fk_run(lib, m, q, S=1)
    assert torch.equal(xpos_k, xpos_1) and torch.equal(xquat_k, xquat_1)
    xpos_p, xquat_p = fk.fk_pose_plain(m, q)
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
    lib.rs_contact_solve(*(_p(t) for t in args), _p(qv_k), _p(f_k), B, m.nv, 96, 0, C.APGD_ITERS, C.POWER_ITERS,
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
    """The fused substep's shared memory per scenario, as the C carve
    (rs_substep_smem_bytes, which the launcher sizes its blocks by) gives
    it: Lift's (OSC) sits below Stack's, the 2-point planning model below
    the execution model, and a block fits the card's 227 KB at the
    library's scenarios per block (RS_S_SUBSTEP) and at every value the
    sweep of ab_kernels.py builds."""
    sizes = {}
    for label, env, m in _models():
        t = tables.fill(m, arm=substep.extract_spec(env, m))
        c_bytes = lib.rs_substep_smem_bytes(ctypes.addressof(t))
        assert c_bytes > 0 and c_bytes % 16 == 0, label
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
