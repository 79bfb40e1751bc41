"""K3's four variants, K1 and K2 timed on one card for two trees of this
package, the stage split of K3, and the scenarios-per-block sweep.

    git archive <commit> robosuite_tpu_torch | tar -x -C <dir>
    python -m robosuite_tpu_torch.ab_kernels <dir>     # A/B, then the split
    python -m robosuite_tpu_torch.ab_kernels split     # the split alone
    python -m robosuite_tpu_torch.ab_kernels sweep     # scenarios per block

run from the repository root on a machine with a CUDA GPU and nvcc.

A/B: the parent tree in <dir> and this one, in the order parent, this,
this, parent, each in its own process (so each loads its own kernel
build). Each run prints one JSON line: ms per launch of K3 (OSC), K1 and
K2 at B=512 at a contact-rich Lift state (the arm driven onto the cube,
fingers closing) and K3-aux at B=4096 on Lift's 2-point planning model;
of K3-JP at B=32 and 512, K1 and K2 at B=512 and K3-aux-JP at B=512 on
Stack's planning model (dt 25 ms, 10 solver iterations) at a Stack state
after a reset and four policy steps; and, where the tree reports it, each
K3 variant's resident scenarios per SM.
K2's operands are the plain path's at each state. Each case is timed two
ways after a warm-up: by CUDA events around its calls (`<case>_ms_B<n>`,
which includes any wait for the wrapper on the host) and by the
profiler's device time of its rs_* kernels alone (`<case>_dev_ms_B<n>`).

Split: a diagnostic build of this tree's kernels (nvcc -DRS_STAGE_CLOCKS,
its own build directory; the port never loads it) records clock64() at the
end of each stage of block 0's first scenario (csrc/common.cuh RS_STAMP).
One launch per case (K3 at B=512, K3-aux at B=4096, K3-JP at B=32,
K3-aux-JP at B=512) prints the cycles of each stage and their share.

Sweep: this tree's kernels built with 1, 2 and 4 scenarios (warps) a block
(nvcc -DRS_S_FORWARD=S -DRS_S_SOLVE=S -DRS_S_SUBSTEP=S, a build directory
each, all three compiled at once), each case timed in each build, with each
K3 variant's resident scenarios per SM: the measurement behind the defaults
in csrc/common.cuh.
"""
import ctypes
import json
import os
import subprocess
import sys

SWEEP = (1, 2, 4)
STAGES = ("load", "tree walk", "poses", "CRBA", "RNEA", "torque law", "smooth forces", "narrowphase", "rows",
          "Cholesky 1 + whitening", "power iterations", "APGD", "Cholesky 2", "integration", "aux tail")


def _k2_args(env, s, leaves, torch):
    """K2's operands as the plain path forms them at states s, and its
    iteration counts."""
    from robosuite_tpu_torch.ops import forward
    from robosuite_tpu_torch.physics import contact as C
    from robosuite_tpu_torch.physics import engine

    model, B = env.model, s.physics.qpos.shape[0]
    q, qd = s.physics.qpos, s.physics.qvel
    kin, M, bias = forward.forward_plain(model, q, qd, *leaves)
    ctrl = env.robots[0].run_controllers(kin, M, bias, q, qd, s.ctrl, torch.zeros(B, model.nu, device="cuda"))
    qfrc, extra = engine.total_smooth_force(model, q, qd, ctrl, M, bias)
    JfT, aref, reg3, mu, act = C.solver_inputs(model, kin, C.narrowphase(model, kin), qd, model.timestep)
    return tuple(t.contiguous() for t in (M, JfT, aref, qfrc, qd, model.dof_damping + extra, reg3, mu, act)) + (
        C.APGD_ITERS, C.POWER_ITERS, model.timestep)


def _cases(R, forward, engine, torch):
    """{name: (wrapper, args, batch)} for the timed kernels."""
    from robosuite_tpu_torch.ops import contact_solve

    cases = {}
    B = 512
    env = R.make("Lift", robots="Panda", reward_shaping=True, seed=0)
    model = env.model
    s, _ = env.reset_batch(B, torch.Generator(device="cuda").manual_seed(0))
    for i in range(16):  # chip_smoke.py's contact-rich Lift state
        eef = env._get_observations(s.physics, engine.forward_products(model, s.physics.qpos, s.physics.qvel)[0])
        a = torch.zeros(B, env.action_dim, device="cuda")
        a[:, :3] = torch.clamp(-eef["gripper_to_cube_pos"] * 40.0, -1.0, 1.0)
        a[:, 6] = -1.0 if i < 12 else 1.0
        s, _ = env.rollout_batch(s, a)
    q, qd = s.physics.qpos, s.physics.qvel
    leaves = forward.runtime_leaves(model, B)
    kin = forward.forward_plain(model, q, qd, *leaves)[0]
    robot = env.robots[0]
    goal, gains = env._fused_goal_fn(robot, "right", s.ctrl, kin)
    args = (q, qd, *leaves, goal, gains, robot.gripper_ctrl("right", s.ctrl).contiguous())
    cases["K3"] = (env._fused_for(model), args, B)
    plan = model.replace(timestep=0.025, solver_iters=10, pair_points_cap=2)
    cases["K3-aux"] = (env._fused_for(plan, emit_aux=True),
                       tuple(t.repeat((8,) + (1,) * (t.dim() - 1)) for t in args), 8 * B)
    cases["K1"] = (lambda *a, m=model: forward.forward_products(m, *a), (q, qd, *leaves), B)
    cases["K2"] = (contact_solve.vel_update, _k2_args(env, s, leaves, torch), B)

    env = R.make("Stack", robots="Panda", controller_configs="JOINT_POSITION", reward_shaping=True)
    model, robot = env.model, env.robots[0]
    gen = torch.Generator(device="cuda").manual_seed(20)
    s, _ = env.reset_batch(B, gen)
    a = torch.clamp(0.5 * torch.randn(B, env.action_dim, generator=gen, device="cuda"), -1.0, 1.0)
    for _ in range(4):
        s, _ = env.rollout_batch(s, a)
    q, qd = s.physics.qpos, s.physics.qvel
    leaves = forward.runtime_leaves(model, B)
    kin = forward.forward_plain(model, q, qd, *leaves)[0]
    goal, gains = env._fused_goal_fn(robot, "right", s.ctrl, kin)
    args = (q, qd, *leaves, goal, gains, robot.gripper_ctrl("right", s.ctrl).contiguous())
    fused = env._fused_for(model)
    cases["K3-JP-32"] = (fused, tuple(t[:32].contiguous() for t in args), 32)
    cases["K3-JP"] = (fused, args, B)
    plan = model.replace(timestep=0.025, solver_iters=10)
    cases["K3-aux-JP"] = (env._fused_for(plan, emit_aux=True), args, B)
    cases["K1-Stack"] = (lambda *a, m=model: forward.forward_products(m, *a), (q, qd, *leaves), B)
    cases["K2-Stack"] = (contact_solve.vel_update, _k2_args(env, s, leaves, torch), B)
    return cases


DIAG = ("-DRS_STAGE_CLOCKS",)


def _sweep_defines(S):
    return tuple(f"-DRS_S_{k}={S}" for k in ("FORWARD", "SOLVE", "SUBSTEP"))


def _ms(torch, fn, args, reps):
    fn(*args)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn(*args)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _device_ms(torch, fn, args, reps):
    """Mean ms per call of the device time of the rs_* kernels that fn
    launches (torch.profiler), free of the host's pace."""
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages() if "rs_" in e.key) / 1e3 / reps


def _time(torch, cases, out):
    """Both times of every case into out."""
    for name, (fn, args, n) in cases.items():
        reps = 10 if n > 1024 else 50
        out[f"{name}_ms_B{n}"] = _ms(torch, fn, args, reps)
        out[f"{name}_dev_ms_B{n}"] = _device_ms(torch, fn, args, reps)


def main(argv):
    me = os.path.abspath(__file__)
    if len(argv) == 2 and argv[1] not in ("split", "sweep"):
        roots = {"parent": os.path.abspath(argv[1]), "this": os.getcwd()}
        builds = [subprocess.Popen([sys.executable, me, "build", r], cwd=r) for r in roots.values()]
        builds.append(subprocess.Popen([sys.executable, me, "build", roots["this"], *DIAG], cwd=roots["this"]))
        if any(p.wait() for p in builds):
            sys.exit("a kernel build failed")
        for name in ("parent", "this", "this", "parent"):
            subprocess.run([sys.executable, me, "time", roots[name], name], cwd=roots[name], check=True)
        argv = [argv[0], "split"]
    if len(argv) == 2:  # split or sweep: build, then run it in a process of its own, on this tree
        variants = [DIAG] if argv[1] == "split" else [_sweep_defines(S) for S in SWEEP]
        builds = [subprocess.Popen([sys.executable, me, "build", os.getcwd(), *d]) for d in variants]
        if any(p.wait() for p in builds):
            sys.exit("a kernel build failed")
        subprocess.run([sys.executable, me, f"{argv[1]}-run", os.getcwd()], check=True)
        return
    mode, root = argv[1], argv[2]
    sys.path[0] = root  # this tree's or the parent's package, not the directory of this file
    import torch

    import robosuite_tpu_torch as R
    from robosuite_tpu_torch.ops import build, forward, substep
    from robosuite_tpu_torch.physics import engine

    if os.path.dirname(os.path.dirname(os.path.abspath(R.__file__))) != root:
        sys.exit(f"imported {R.__file__}, not the tree at {root}")
    if mode == "build":
        if argv[3:]:
            build.build(defines=tuple(argv[3:]))
        else:  # the parent tree's build() takes no defines
            build.build()
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    if mode == "split-run":
        diag = build.load(build.build(defines=DIAG))
        diag.rs_stage_clocks.argtypes = [ctypes.c_void_p]
        diag.rs_stage_clocks.restype = ctypes.c_int
        build.library = lambda: diag  # the wrappers below launch the diagnostic build
    cases = _cases(R, forward, engine, torch)
    resident = getattr(substep, "resident_per_sm", None)
    if mode == "time":
        out = {"tree": argv[3]}
        _time(torch, cases, out)
        if resident is not None:
            out["resident_scenarios_per_sm"] = {k: resident(fn) for k, (fn, _, _) in cases.items() if "K3" in k}
        print(json.dumps(out), flush=True)
        return
    if mode == "sweep-run":  # each case in each build, the builds in turn
        for S in SWEEP:
            lib = build.load(build.build(defines=_sweep_defines(S)))
            build.library = lambda lib=lib: lib
            out = {"scenarios_per_block": S}
            _time(torch, cases, out)
            out["resident_scenarios_per_sm"] = {k: resident(fn) for k, (fn, _, _) in cases.items() if "K3" in k}
            print(json.dumps(out), flush=True)
        return
    mhz = torch.cuda.get_device_properties(0).clock_rate / 1e3 if hasattr(
        torch.cuda.get_device_properties(0), "clock_rate") else None
    clocks = (ctypes.c_longlong * 16)()
    for name in ("K3", "K3-aux", "K3-JP-32", "K3-aux-JP"):
        fn, args, n = cases[name]
        for _ in range(2):  # the second launch is the one read
            diag.rs_stage_clocks(clocks)
            fn(*args)
            torch.cuda.synchronize()
        if diag.rs_stage_clocks(clocks):
            sys.exit("reading the stage clocks failed")
        c = list(clocks)
        last = 15 if "aux" in name else 14
        split = {STAGES[i - 1]: c[i] - c[i - 1] for i in range(1, last + 1)}
        total = c[last] - c[0]
        print(json.dumps({"case": name, "B": n, "total_cycles": total,
                          "total_us_at_max_clock": total / mhz if mhz else None, "cycles": split,
                          "share": {k: round(v / total, 4) for k, v in split.items()}}), flush=True)


if __name__ == "__main__":
    main(sys.argv)
