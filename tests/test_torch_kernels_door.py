"""The kernels' device code on the Door world, compiled for the CPU (as
tests/test_torch_kernels_host.py does, over its harness): K3 and K3-aux
at Door's 60 pairs and 170 rows, over one lane and over a 32-thread team,
against their plain versions; K2 at nv 11 and 170 rows; the fused
substep's carve for Door; and the two candidate kinds Door brings,
plane-cylinder and cylinder-cylinder (csrc/narrowphase.cuh
plane_cylinder, capsule_capsule), on small worlds with an active contact:
every row's depth, point and normal and each pair's minimum distance
against the plain narrowphase (physics/contact.py), over one lane and over
a 32-thread team; the maxima's gate (Door fits, a larger world is
refused); and the fused gate's predicate, the JAX package's. Tolerances
are chip_smoke.py's."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from robosuite_tpu_torch import ab_kernels, convert
from robosuite_tpu_torch.models import model as PM
from robosuite_tpu_torch.ops import build, contact_solve, forward, substep, tables
from robosuite_tpu_torch.physics import contact as C
from robosuite_tpu_torch.physics import engine, kinematics
from tests.test_torch_door import PAIR_WORLDS, envs, one_thread, pair_world_models  # noqa: F401  (fixtures)
from tests.test_torch_kernels_host import CARD_ONLY, CSRC, HARNESS, HOST_ONLY, _p

# The narrowphase alone, over one lane or a team of nt CPU threads: the
# pose-only walk, the candidates and the cut, then each kept row's point
# and normal (computed again from its candidate, as the rows are
# assembled) and each pair's minimum candidate depth.
NARROW = r"""
extern "C" int rs_narrowphase_threads(int nt, const void* T, const float* qpos, float* row_dist, float* row_pos,
    float* row_nrm, float* pdist, int B) {
  const RsTables& t = *(const RsTables*)T;
  for (int b = 0; b < B; ++b) {
    std::vector<double> buf;
    float* base = scratch(buf, rs_substep_smem_bytes(T) / 4);
    auto body = [&](const auto& tm) {
      Sub sh;
      carve_substep(t, base, sh);
      const Fwd& fw = sh.fw;
      for (int i = tm.rank(); i < t.nq; i += tm.size()) fw.q[i] = qpos[(size_t)b * t.nq + i];
      tm.sync();
      walk_team<false>(tm, t, fw.q, fw);
      for (int i = tm.rank(); i < t.nbody; i += tm.size()) quat2mat(fw.xquat[i], fw.xmat[i]);
      tm.sync();
      narrowphase_team(tm, t, fw, sh.nw);
      for (int r = tm.rank(); r < t.nrows; r += tm.size()) {
        const int p = t.row_pair[r];
        const size_t o = (size_t)b * t.nrows + r;
        row_dist[o] = sh.nw.row_dist[r];
        candidate(t, sh.nw.pf[p], p, sh.nw.row_cand[r], row_pos + 3 * o, row_nrm + 3 * o);
      }
      tm.sync();
      candidates_team(tm, t, fw, sh.nw);  // the cut raised the kept depths
      pair_min_team(tm, t, sh.nw, pdist + (size_t)b * t.npair);
      tm.sync();
    };
    if (nt == 1) body(HostTeam());
    else on_team(nt, [&](const ThreadTeam& tm) { body(tm); });
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernels' device code for the CPU")
    d = tmp_path_factory.mktemp("kernels_door")
    src, so = d / "harness.cpp", d / "libharness.so"
    src.write_text(HARNESS + NARROW)
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-pthread", f"-I{CSRC}", str(src), "-o", str(so)],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    signatures = {**build._SIGNATURES, **HOST_ONLY,
                  "rs_narrowphase_threads": [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int]}
    for name, args in signatures.items():
        if name not in CARD_ONLY:
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = ctypes.c_int
    assert lib.rs_tables_size() == ctypes.sizeof(tables.RsTables)
    return lib


@pytest.fixture(scope="module")
def door(envs):  # noqa: F811
    """The port's Door env and 8 scenarios of chip_smoke.py's Door contact
    state (ab_kernels.door_contact_state): the finger pads on the handle,
    the hinge past each limit and the latch near each stop in one
    scenario each."""
    _, penv = envs
    s, _ = penv.reset_batch(8, torch.Generator().manual_seed(0))
    return penv, ab_kernels.door_contact_state(penv, s)


def _assert_rich(act):
    """The contact state reaches Door's rows past 96 (box-box, the finger
    pads' on the handle among them), above the maxima before this world,
    and at least half its scenarios have 4 active rows or more."""
    rows = torch.arange(act.shape[1])
    assert int(torch.where(act > 0, rows, -1).max()) >= 96
    assert 2 * int((act.sum(1) >= 4).sum()) >= act.shape[0]


def _k3_inputs(env, m, s):
    q, qd = s.physics.qpos.contiguous(), s.physics.qvel.contiguous()
    leaves = forward.runtime_leaves(m, q.shape[0])
    kin = forward.forward_plain(m, q, qd, *leaves)[0]
    robot = env.robots[0]
    goal, gains = env._fused_goal_fn(robot, "right", s.ctrl, kin)
    return (q, qd, *leaves, goal, gains, robot.gripper_ctrl("right", s.ctrl).contiguous())


@pytest.mark.parametrize("emit_aux", [False, True], ids=["K3", "K3-aux"])
def test_door_substep_kernel_matches_plain(lib, door, emit_aux):
    """K3 on Door's world and K3-aux on its planning model (dt 25 ms, 10
    solver iterations), over one lane and over a 32-thread team, as
    chip_smoke.py holds them: qpos 1e-5, qvel 1e-3 and f 1e-4 of its
    largest in every scenario but those with a witnessed box-box contact
    near-tie at the input (chip_smoke.hold_all); the aux poses 2e-5 and
    every pair distance 1e-5 against the plain version at the kernel's
    own post-step qpos (a witnessed box-box SAT near-tie set aside, as
    chip_smoke.hold_pair_dist does); the team's outputs as one lane's."""
    import chip_smoke

    env, s = door
    m = env.model.replace(timestep=0.025, solver_iters=10) if emit_aux else env.model
    args = _k3_inputs(env, m, s)
    B = args[0].shape[0]
    kin = forward.forward_plain(m, args[0], args[1], *args[2:6])[0]
    _assert_rich(C.solver_inputs(m, kin, C.narrowphase(m, kin), args[1], m.timestep)[4])
    ref = (substep.substep_aux_plain if emit_aux else substep.substep_plain)(env, m, *args)
    assert ref[2].shape == (B, 510)
    T = tables.pack(m, arm=substep.extract_spec(env, m))
    outs = {}
    for nt in (1, 32):
        out = [torch.empty_like(r) for r in ref]
        aux = out[3:] if emit_aux else [None] * 4
        lib.rs_substep_threads(nt, int(emit_aux), _p(T), *(_p(t) for t in (*args, *out[:3])),
                               *((_p(t) if t is not None else None) for t in aux), B)
        outs[nt] = out
    n0 = len(chip_smoke.FAILED)
    chip_smoke.hold_all("Door K3-aux" if emit_aux else "Door K3", m, args[0], outs[1][:3], ref[:3])
    assert chip_smoke.FAILED[n0:] == []
    for name, k32, k1 in zip(("qpos", "qvel", "f", "site_xpos", "site_xmat", "xpos", "pair_dist"), outs[32], outs[1]):
        assert float((k32 - k1).abs().max()) <= 1e-6 * max(1.0, float(k1.abs().max())), name
    if emit_aux:
        k = outs[1]
        kin2 = kinematics.fk(m, k[0])
        for name, got, want in (("site_xpos", k[3], kin2.site_xpos), ("site_xmat", k[4], kin2.site_xmat),
                                ("xpos", k[5], kin2.xpos)):
            assert float((got - want).abs().max()) <= 2e-5, name
        pd = C.pair_min_dists(m, kin2)
        assert float(pd.min()) < 0.0  # some pair touches
        assert chip_smoke.hold_pair_dist("Door K3-aux", m, k[-1], pd, k[0], k[0], tol=1e-5) <= 1e-5


def test_door_contact_solve_kernel_matches_plain(lib, door):
    """K2 at Door's width (nv 11, 170 rows) on the plain path's operands."""
    env, s = door
    m = env.model
    B = s.physics.qpos.shape[0]
    q, qd = s.physics.qpos, s.physics.qvel
    kin, M, bias = forward.forward_plain(m, q, qd, *forward.runtime_leaves(m, B))
    ctrl = env.robots[0].run_controllers(kin, M, bias, q, qd, s.ctrl, torch.zeros(B, m.nu))
    qfrc, extra = engine.total_smooth_force(m, q, qd, ctrl, M, bias)
    JfT, aref, reg3, mu, act = C.solver_inputs(m, kin, C.narrowphase(m, kin), qd, m.timestep)
    assert act.shape[1] == 170
    _assert_rich(act)
    args = [t.contiguous() for t in (M, JfT, aref, qfrc, qd, m.dof_damping + extra, reg3, mu, act)]
    qv_p, f_p = contact_solve.vel_update_plain(*args, C.APGD_ITERS, C.POWER_ITERS, m.timestep)
    qv_k, f_k = torch.empty_like(qv_p), torch.empty_like(f_p)
    lib.rs_contact_solve(*(_p(t) for t in args), _p(qv_k), _p(f_k), B, m.nv, 170, 0, C.APGD_ITERS, C.POWER_ITERS,
                         m.timestep, None)
    assert float((qv_k - qv_p).abs().max()) <= 1e-4
    assert float((f_k - f_p).abs().max()) <= 1e-4 * max(1.0, float(f_p.abs().max()))


def test_door_substep_carve(lib, door):
    """The fused substep's shared memory per scenario for Door and its
    planning model: above Stack's (more rows and pairs), a 16-byte
    multiple, and a block within the card's 227 KB at the library's and
    at every swept scenarios per block."""
    import robosuite_tpu_torch

    env, _ = door
    stack = robosuite_tpu_torch.make("Stack", robots="Panda", controller_configs="JOINT_POSITION", device="cpu")
    sizes = {}
    for label, e, m in (("Door", env, env.model),
                        ("Door planning", env, env.model.replace(timestep=0.025, solver_iters=10)),
                        ("Stack", stack, stack.model)):
        t = tables.fill(m, arm=substep.extract_spec(e, m))
        c_bytes = lib.rs_substep_smem_bytes(ctypes.addressof(t))
        assert c_bytes > 0 and c_bytes % 16 == 0, label
        assert max(lib.rs_s_substep(), *ab_kernels.SWEEP) * c_bytes <= 232448, label
        sizes[label] = c_bytes
    assert sizes["Stack"] < sizes["Door planning"] <= sizes["Door"]


@pytest.mark.parametrize("nt", [1, 32])
@pytest.mark.parametrize("world", PAIR_WORLDS, ids=[w[0] for w in PAIR_WORLDS])
def test_new_candidate_kinds_match_plain(lib, door, world, nt):
    _, plane, cyls = world
    _, pm, qpos = pair_world_models(plane, cyls)
    # the pair world's pose and two more, the bodies nudged and turned
    rng = np.random.default_rng(0)
    q = np.repeat(qpos[None], 3, axis=0)
    for i in range(len(cyls)):
        q[1:, 7 * i:7 * i + 3] += 0.002 * rng.standard_normal((2, 3))
        q[1:, 7 * i + 3:7 * i + 7] += 0.05 * rng.standard_normal((2, 4))
    q = torch.as_tensor(q, dtype=torch.float32)
    kin = kinematics.fk(pm, q)
    con = C.narrowphase(pm, kin)
    pd = C.pair_min_dists(pm, kin)
    assert float(con["dist"][0].min()) < 0.0  # an active contact
    B, R = q.shape[0], con["dist"].shape[1]
    T = tables.pack(pm, arm=substep.extract_spec(door[0], pm))  # the fused substep's table: it has the contact part
    dist, pos, nrm, pmin = (torch.full(shape, float("nan")) for shape in ((B, R), (B, R, 3), (B, R, 3), (B, pm.npair)))
    lib.rs_narrowphase_threads(nt, _p(T), _p(q), _p(dist), _p(pos), _p(nrm), _p(pmin), B)
    np.testing.assert_allclose(dist.numpy(), con["dist"].numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(pos.numpy(), con["pos"].numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose((nrm / nrm.norm(dim=-1, keepdim=True)).numpy(), con["normal"].numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(pmin.numpy(), pd.numpy(), rtol=0, atol=1e-5)


def test_maxima_take_door_and_refuse_more(door):
    """Door (11 dofs, 60 pairs, 170 rows) fits the kernels' maxima with and
    without the latch; a world above them (three free bodies of six boxes
    each on a plane: 126 pairs) is refused by the table with a ValueError;
    the fused substep's gate refuses it first for its row compaction (504
    rows at nv 18, the JAX predicate) and, with one point a pair (no
    compaction), with the table's ValueError."""
    import robosuite_tpu_torch
    from robosuite_tpu.models import spec as JS

    env, _ = door
    no_latch = robosuite_tpu_torch.make("Door", robots="Panda", seed=0, use_latch=False, device="cpu")
    for e in (env, no_latch):
        assert tables.check_model(e.model) == (170 if e.use_latch else 124)
        assert substep.extract_spec(e, e.model)["ctrl_type"] == "osc"
    ms = JS.ModelSpec("boxes")
    ms.worldbody.add_geom(JS.GeomSpec("floor", type="plane", size=(1.0, 1.0, 0.1)))
    for i in range(3):
        b = ms.worldbody.add_body(JS.BodySpec(f"b{i}", pos=(0.3 * i, 0.0, 0.05)))
        b.add_joint(JS.JointSpec(f"j{i}", type="free"))
        for k in range(6):
            b.add_geom(JS.GeomSpec(f"g{i}_{k}", type="box", size=(0.02, 0.02, 0.02), pos=(0.05 * k, 0.0, 0.0)))
    jm = ms.compile()
    big = convert.model_from_numpy({n: np.asarray(getattr(jm, n)) for n in PM.LEAVES},
                                   {n: getattr(jm, n) for n in PM.STATIC}, device="cpu")
    assert big.npair == 126
    with pytest.raises(ValueError, match="npair=126"):
        tables.fill(big, arm=substep.extract_spec(env, env.model))
    assert C.uses_row_compaction(big)
    with pytest.raises(substep.UnsupportedFused, match="compacts"):
        substep.extract_spec(env, big)
    assert env._fused_for(big) is None
    one_point = big.replace(pair_points_cap=1)
    assert not C.uses_row_compaction(one_point)
    with pytest.raises(ValueError, match="npair=126"):
        substep.extract_spec(env, one_point)
    with pytest.raises(ValueError, match="npair=126"):
        env._fused_for(one_point)


@pytest.mark.parametrize("kinds", [["sphere", "box"], ["can"]], ids=["sphere_box", "hull"])
def test_fused_gate_follows_the_reference(door, kinds):
    """The fused substep's gate refuses by the JAX predicate: a world that
    does not compact its rows, with a pair type the reference fuses but
    the kernel lacks (plane-sphere, sphere-box), fails loudly rather than
    stepping the plain path on the card; one with a pair type the
    reference does not fuse (a mesh) runs unfused, as there."""
    from robosuite_tpu.ops import pallas_substep as JP
    from tests.test_torch_contact_hull import small_world

    env, _ = door
    jm, pm = small_world(True, kinds)
    assert not C.uses_row_compaction(pm)
    if kinds == ["can"]:
        with pytest.raises(JP.UnsupportedFused, match="pair type"):
            JP._pair_meta(jm)
        with pytest.raises(substep.UnsupportedFused, match="pair type"):
            substep.extract_spec(env, pm)
        assert env._fused_for(pm) is None
        return
    JP._pair_meta(jm)  # the reference fuses every pair type of this world
    with pytest.raises(NotImplementedError, match="no CUDA narrowphase"):
        substep.extract_spec(env, pm)
    with pytest.raises(NotImplementedError, match="no CUDA narrowphase"):
        env._fused_for(pm)
