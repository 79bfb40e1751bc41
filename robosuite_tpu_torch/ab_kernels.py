"""Lift's K3, K3-aux and K1 timed on one card for two trees of this
package: a parent tree and this one, in the order parent, this, this,
parent, each in its own process (so each loads its own kernel build).

    git archive <commit> robosuite_tpu_torch | tar -x -C <dir>
    python -m robosuite_tpu_torch.ab_kernels <dir>

run from the repository root on a machine with a CUDA GPU and nvcc. Each
run prints one JSON line: the tree, and ms per launch of K3 at B=512 and
K1 at B=512 at chip_smoke.py's contact-rich Lift state, and of K3-aux at
B=4096 on the 2-point planning model (CUDA events, after a warm-up).
"""
import json
import os
import subprocess
import sys


def main(argv):
    if len(argv) == 2:
        roots = {"parent": os.path.abspath(argv[1]), "this": os.getcwd()}
        me = os.path.abspath(__file__)
        procs = [subprocess.Popen([sys.executable, me, "build", r], cwd=r) for r in roots.values()]
        if any(p.wait() for p in procs):
            sys.exit("a kernel build failed")
        for name in ("parent", "this", "this", "parent"):
            subprocess.run([sys.executable, me, "time", roots[name], name], cwd=roots[name], check=True)
        return
    mode, root = argv[1], argv[2]
    sys.path[0] = root  # this tree's or the parent's package, not the directory of this file
    import torch

    import robosuite_tpu_torch as R
    from robosuite_tpu_torch.ops import build, forward
    from robosuite_tpu_torch.physics import engine

    if os.path.dirname(os.path.dirname(os.path.abspath(R.__file__))) != root:
        sys.exit(f"imported {R.__file__}, not the tree at {root}")
    if mode == "build":
        build.library()
        return
    torch.backends.cuda.matmul.allow_tf32 = False

    def ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    B = 512
    env = R.make("Lift", robots="Panda", reward_shaping=True, seed=0)
    model = env.model
    s, _ = env.reset_batch(B, torch.Generator(device="cuda").manual_seed(0))
    for i in range(16):  # chip_smoke.py's contact-rich state
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
    fused = env._fused_for(model)
    fused_aux = env._fused_for(model.replace(timestep=0.025, solver_iters=10, pair_points_cap=2), emit_aux=True)
    a8 = tuple(t.repeat((8,) + (1,) * (t.dim() - 1)) for t in args)
    print(json.dumps(dict(tree=argv[3], K3_ms_B512=ms(lambda: fused(*args), 50),
                          K3_aux_ms_B4096=ms(lambda: fused_aux(*a8), 10),
                          K1_ms_B512=ms(lambda: forward.forward_products(model, q, qd, *leaves), 50))), flush=True)


if __name__ == "__main__":
    main(sys.argv)
