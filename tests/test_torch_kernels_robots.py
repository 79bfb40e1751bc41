"""The fused substep kernel's device code on the new robots' fused worlds,
compiled for the CPU (as tests/test_torch_kernels_host.py does, over its
harness): K3 and K3-aux on Lift with PandaDexRH (an Inspire hand: 12
gripper actuators, K3's maximum raised from 4 to 12), Lift with SpotArm (a
6-dof OSC arm) and Stack with PandaDexLH (nv 31, the widest fused world),
against their plain versions at chip_smoke.py's tolerances; and the fused
substep's carve for these worlds within the card's shared memory."""

import ctypes
import shutil
import subprocess

import pytest
import torch

from robosuite_tpu_torch import ab_kernels
from robosuite_tpu_torch.ops import build, forward, substep, tables
from robosuite_tpu_torch.physics import contact as C
from robosuite_tpu_torch.physics import kinematics
from tests.test_torch_kernels_host import CARD_ONLY, CSRC, HARNESS, HOST_ONLY, _p

WORLDS = {"Lift-PandaDexRH": ("Lift", "PandaDexRH"), "Lift-SpotArm": ("Lift", "SpotArm"),
          "Stack-PandaDexLH": ("Stack", "PandaDexLH")}


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
    d = tmp_path_factory.mktemp("kernels_robots")
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


_STATES = {}


def state(key):
    """(env, 4 scenarios): the reset, the cubes pressed 1 mm into the table
    (active contact rows), small arm velocities, and a gripper command
    that is not zero (the hand's fingers part-closed, differently on each
    actuator)."""
    if key not in _STATES:
        import robosuite_tpu_torch

        name, robot = WORLDS[key]
        env = robosuite_tpu_torch.make(name, robots=robot, reward_shaping=True, device="cpu",
                                       **({"seed": 0} if name == "Lift" else {}))
        s, _ = env.reset_batch(4, torch.Generator().manual_seed(41))
        q, qd = s.physics.qpos.clone(), s.physics.qvel.clone()
        m = env.model
        for cube in ("cube", "cubeA", "cubeB"):
            if cube + "_joint0" in m.jnt_names:
                z = m.jnt_qpos_slice(cube + "_joint0").start + 2
                q[:, z] = 0.8 - float(getattr(env, cube).bottom_offset[2]) - 0.001
        g = torch.Generator().manual_seed(42)
        robot_ = env.robots[0]
        qd[:, robot_.arm_qvel_idx["right"]] = 0.1 * torch.randn(4, len(robot_.arm_qvel_idx["right"]), generator=g)
        s = env.state_from_flattened(torch.cat([s.physics.time[:, None], q, qd], 1))
        n = s.ctrl.gripper_action["right"].shape[1]
        s.ctrl.gripper_action["right"] = torch.rand(4, n, generator=g) * 2.0 - 1.0
        _STATES[key] = env, s
    return _STATES[key]


def _k3_inputs(env, m, s):
    q, qd = s.physics.qpos.contiguous(), s.physics.qvel.contiguous()
    leaves = forward.runtime_leaves(m, q.shape[0])
    kin = forward.forward_plain(m, q, qd, *leaves)[0]
    robot = env.robots[0]
    goal, gains = env._fused_goal_fn(robot, "right", s.ctrl, kin)
    return (q, qd, *leaves, goal, gains, robot.gripper_ctrl("right", s.ctrl).contiguous())


@pytest.mark.parametrize("emit_aux", [False, True], ids=["K3", "K3-aux"])
@pytest.mark.parametrize("key", list(WORLDS))
def test_substep_kernel_matches_plain(lib, key, emit_aux):
    """K3 on the world and K3-aux on its planning model (dt 25 ms, 10 solver
    iterations), over one lane, as chip_smoke.py holds them: qpos 1e-5,
    qvel 1e-3 and f 1e-4 of its largest in every scenario (hold_all); the
    aux poses 2e-5 and every pair distance 1e-5 against the plain version
    at the kernel's own post-step qpos. The table carries the arm's dofs
    (6 or 7) and the gripper actuators (1 or 12), and contact rows are
    active."""
    import chip_smoke

    env, s = state(key)
    m = env.model.replace(timestep=0.025, solver_iters=10) if emit_aux else env.model
    args = _k3_inputs(env, m, s)
    B = args[0].shape[0]
    kin = forward.forward_plain(m, args[0], args[1], *args[2:6])[0]
    act = C.solver_inputs(m, kin, C.narrowphase(m, kin), args[1], m.timestep)[4]
    assert bool((act.sum(1) >= 1).all())
    spec = substep.extract_spec(env, m)
    t = tables.fill(m, arm=spec)
    assert (t.na, t.ngrip) == {"Lift-SpotArm": (6, 1)}.get(key, (7, 12))
    ref = (substep.substep_aux_plain if emit_aux else substep.substep_plain)(env, m, *args)
    T = tables.pack(m, arm=spec)
    out = [torch.empty_like(r) for r in ref]
    aux = out[3:] if emit_aux else [None] * 4
    lib.rs_substep_threads(1, int(emit_aux), _p(T), *(_p(x) for x in (*args, *out[:3])),
                           *((_p(x) if x is not None else None) for x in aux), B)
    n0 = len(chip_smoke.FAILED)
    chip_smoke.hold_all(f"{key} {'K3-aux' if emit_aux else 'K3'}", m, args[0], out[:3], ref[:3])
    assert chip_smoke.FAILED[n0:] == []
    if emit_aux:
        kin2 = kinematics.fk(m, out[0])
        for name, got, want in (("site_xpos", out[3], kin2.site_xpos), ("site_xmat", out[4], kin2.site_xmat),
                                ("xpos", out[5], kin2.xpos)):
            assert float((got - want).abs().max()) <= 2e-5, name
        pd = C.pair_min_dists(m, kin2)
        assert chip_smoke.hold_pair_dist(f"{key} K3-aux", m, out[-1], pd, out[0], out[0], tol=1e-5) <= 1e-5


def test_substep_carve_robots(lib):
    """The fused substep's shared memory a scenario for the new fused
    worlds: Stack-PandaDexLH (nv 31, 11 pairs) the largest of them, each a
    16-byte multiple, and a block within the card's 227 KB (232,448 B) at
    the library's and at every swept scenarios per block."""
    sizes = {}
    for key in WORLDS:
        env, _ = state(key)
        for label, m in ((key, env.model), (f"{key} planning", env.model.replace(timestep=0.025, solver_iters=10))):
            t = tables.fill(m, arm=substep.extract_spec(env, m))
            c_bytes = lib.rs_substep_smem_bytes(ctypes.addressof(t))
            assert c_bytes > 0 and c_bytes % 16 == 0, label
            assert max(lib.rs_s_substep(), *ab_kernels.SWEEP) * c_bytes <= 232448, label
            sizes[label] = c_bytes
    assert max(sizes, key=sizes.get) == "Stack-PandaDexLH"
