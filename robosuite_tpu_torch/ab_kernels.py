"""The port's kernels timed on one card for two trees of this package, the
stage splits of K3 and K1, and the sweeps of their launch layouts.

    git archive <commit> robosuite_tpu_torch | tar -x -C <dir>
    python -m robosuite_tpu_torch.ab_kernels <dir>      # A/B, then the splits
    python -m robosuite_tpu_torch.ab_kernels split      # the splits alone
    python -m robosuite_tpu_torch.ab_kernels sweep      # K1's and K4's layouts
    python -m robosuite_tpu_torch.ab_kernels sweep-k3   # K2's and K3's scenarios a block
    python -m robosuite_tpu_torch.ab_kernels aux-draw <dir>   # K3-aux of both trees on one input

run from the repository root on a machine with a CUDA GPU and nvcc.

A/B: the parent tree in <dir> and this one, in the order parent, this,
this, parent, each in its own process (so each loads its own kernel
build). Each run prints one JSON line: ms per launch of K3 (OSC) and K2 at
B=512 at a contact-rich Lift state (the arm driven onto the cube, fingers
closing) and K3-aux at B=4096 on Lift's 2-point planning model; K1 at that
state at every width the paths launch it at (Lift: 128 and 512, the iLQR
rollouts; 512, the env step; 4096, the MPPI start; 335,872, the
forward-difference sweep; Stack: 32 and 512), called as the paths call it
(the model's own leaves), and at 4096 and 335,872 on distinct random arm
poses and velocities (`K1-random`); K4 at 8192 and 32768 (the iLQR costs) at random
arm poses; K3-JP at B=32 and 512, K2 at B=512 and K3-aux-JP at B=512 on
Stack's planning model (dt 25 ms, 10 solver iterations) at a Stack state
after a reset and four policy steps; K2, K3 (OSC) at B=512 and K3-aux
at B*K=512 on Door's planning model (dt 25 ms, 10 solver iterations) at
chip_smoke.py's Door contact state (the gripper driven onto the handle,
the hinge past its limits and the latch near its stops in some
scenarios), where the tree has the Door env; K1 at 512 and 32 and K2 at
512 on each unfused world the tree has (UNFUSED: PickPlaceCan, TwoArmLift,
TwoArmPegInHole, NutAssemblySingle, Wipe, TwoArmHandover, ToolHang,
TwoArmTransport) at its contact state (pickplace_contact_state,
twoarm_lift_contact_state, peg_contact_state, nut_contact_state,
wipe_contact_state, handover_contact_state, tool_hang_contact_state,
transport_contact_state); and, where the tree reports
it, each K3 variant's resident scenarios per SM. K2's operands are the plain
path's at each state. Each case is timed two ways after a warm-up: by CUDA
events around its calls (`<case>_ms_B<n>`, which includes any wait for the
wrapper on the host) and by the profiler's device time of its rs_* kernels
alone (`<case>_dev_ms_B<n>`); K1 and K4 up to B=4096 also by the host
time of a call, queued without a wait (`<case>_host_us_B<n>`).

Split: a diagnostic build of this tree's kernels (nvcc -DRS_STAGE_CLOCKS,
its own build directory; the port never loads it) records clock64() at the
end of each stage of block 0's first scenario (csrc/common.cuh RS_STAMP).
One launch per case (K3 at B=512, K3-aux at B=4096, K3-JP at B=32,
K3-aux-JP at B=512, K3 and K3-aux on Door at B=512; K1 on Lift at 512 and 335,872 and on Stack at 512;
K4 at 8192 and 32768) prints the cycles of each stage and their share.

Sweep: this tree's kernels built with each pair of K1_SWEEP (K1's and
K4's scenarios a block, nvcc -DRS_S_FORWARD -DRS_S_FK; a build directory
each, all compiled at once), each K1 and K4 case timed in each build: the
measurement behind the defaults in csrc/common.cuh.
Sweep-k3: the full library built with 1, 2 and 4 scenarios (warps) a block
of K2 and K3 (nvcc -DRS_S_SOLVE=S -DRS_S_SUBSTEP=S), their cases timed in
each, with each K3 variant's resident scenarios per SM.

Aux-draw: K3-aux of the parent tree in <dir> and of this one on the same
inputs, chip_smoke.py phase 9's at B*K=4096 (made once, by this tree, and
saved): the velocity offsets of phase 9 (AUX_DRAWS "phase9") and a second
draw of them from the same seed ("second", the draw phase 9 gets when its
generator has first made K1's random velocities too). Each tree holds its
outputs against the plain version with chip_smoke.py's tolerances and
hold_pair_dist (also the distances recomputed in float64 at the kernel's
post-step qpos, what a float64-exact kernel would give), and prints, for
each (scenario, pair) past the distance tolerance, that pair's minimum
distance recomputed in float64 from the float64 poses, from the plain
float32 poses and from K1's, and its best edge pair's |a x b|; then the
two trees' outputs are compared bit for bit.
"""
import concurrent.futures
import ctypes
import json
import math
import os
import subprocess
import sys

SWEEP = (1, 2, 4)  # sweep-k3's scenarios a block
K1_SWEEP = ((4, 32), (2, 64), (8, 128))  # sweep: (K1, K4) scenarios a block
STAGES = ("load", "tree walk", "poses", "CRBA", "RNEA", "torque law", "smooth forces", "narrowphase", "rows",
          "Cholesky 1 + whitening", "power iterations", "APGD", "Cholesky 2", "integration", "aux tail")
K1_STAGES = ("load", "tree walk", "poses", "CRBA", "RNEA", "frames", "store")
K4_STAGES = ("load", "joint terms + walk", "store")
K1_WIDTHS = (128, 512, 4096, 335872)   # Lift: iLQR rollouts, env step, MPPI start, FD sweep
K1_STACK_WIDTHS = (32, 512)            # Stack: the executed MPC step, env step and MPPI start
K4_WIDTHS = (8192, 32768)              # the iLQR stage and terminal costs
K1_RANDOM_WIDTHS = (4096, 335872)      # K1 on distinct random scenarios too
# aux-draw: the (count, width) normal draws made from chip_smoke.py's seed 4
# before K3-aux's velocity offsets: K1's random arm poses, and with
# "second" its random velocities too
AUX_DRAWS = {"phase9": ((32768, 7),), "second": ((32768, 7), (32768, "nv"))}


def _k2_args(env, s, leaves, torch):
    """K2's operands as the plain path forms them at states s, and its
    iteration counts."""
    from robosuite_tpu_torch.ops import forward
    from robosuite_tpu_torch.physics import contact as C
    from robosuite_tpu_torch.physics import engine

    model, B = env.model, s.physics.qpos.shape[0]
    q, qd = s.physics.qpos, s.physics.qvel
    kin, M, bias = forward.forward_plain(model, q, qd, *leaves)
    if len(env.robots) > 1:
        ctrl = env.run_controllers(kin, M, bias, q, qd, s.ctrl)
    else:  # an env of a tree before the two-arm worlds has no run_controllers of its own
        ctrl = env.robots[0].run_controllers(kin, M, bias, q, qd, s.ctrl, torch.zeros(B, model.nu, device="cuda"))
    qfrc, extra = engine.total_smooth_force(model, q, qd, ctrl, M, bias)
    JfT, aref, reg3, mu, act = C.solver_inputs(model, kin, C.narrowphase(model, kin), qd, model.timestep)
    return tuple(t.contiguous() for t in (M, JfT, aref, qfrc, qd, model.dof_damping + extra, reg3, mu, act)) + (
        C.APGD_ITERS, C.POWER_ITERS, model.timestep)


# door_drive: policy steps (gripper open) to 8 cm above the handle, (open)
# down onto it, and closing on it
DOOR_DRIVE = ((16, 0.08, -1.0), (12, 0.0, -1.0), (12, 0.0, 1.0))


def door_drive(env, s):
    """Door states s after DOOR_DRIVE's policy steps of OSC deltas: the
    gripper open over the handle, down onto it and closing, its yaw turned
    onto the handle's all along, so that both finger pads close on the
    handle's faces (box-box rows 118-121 and 138-141 of Door's 170) and
    not on each other (rows 102-105, whose faces lie flush at zero depth,
    a SAT tie float32 rounding decides either way)."""
    import math

    import torch

    from robosuite_tpu_torch.physics import engine

    m, B = env.model, s.physics.qpos.shape[0]
    handle = m.geom_name2id(env.door.naming_prefix + "handle")
    pad = m.geom_name2id(env.robot_models[0].grippers["right"].important_geoms["left_fingerpad"][0])
    for n, dz, grip in DOOR_DRIVE:
        for _ in range(n):
            kin = engine.forward_products(m, s.physics.qpos, s.physics.qvel)[0]
            h, p = kin.geom_xmat[:, handle], kin.geom_xmat[:, pad]
            yaw = torch.atan2(h[:, 1, 0], h[:, 0, 0]) - torch.atan2(p[:, 1, 0], p[:, 0, 0])
            to = env._get_observations(s.physics, kin)["handle_to_eef_pos"]
            a = torch.zeros(B, env.action_dim, device=s.physics.qpos.device)
            a[:, :3] = torch.clamp(40.0 * (to + torch.tensor([0.0, 0.0, dz], device=to.device)), -1.0, 1.0)
            a[:, 5] = torch.clamp(4.0 * (torch.remainder(yaw + math.pi / 2, math.pi) - math.pi / 2), -1.0, 1.0)
            a[:, 6] = grip
            s, _ = env.rollout_batch(s, a)
    return s


def door_contact_state(env, s):
    """The contact-rich Door state that chip_smoke.py phases 19-20 hold the
    kernels on and the Door A/B times: door_drive (the handle between the
    finger pads), then one scenario in 8 each with the hinge past its upper
    limit 0.4, one below its lower limit 0, one with the latch near +1.57
    and one near -1.57."""
    import torch

    s = door_drive(env, s)
    qpos = s.physics.qpos.clone()
    b = torch.arange(qpos.shape[0], device=qpos.device)
    qpos[b % 8 == 1, env.hinge_qpos_addr] = 0.42
    qpos[b % 8 == 2, env.hinge_qpos_addr] = -0.02
    qpos[b % 8 == 3, env.handle_qpos_addr] = 1.56
    qpos[b % 8 == 4, env.handle_qpos_addr] = -1.56
    return env.state_from_flattened(torch.cat([s.physics.time[:, None], qpos, s.physics.qvel], 1).cpu())


PICK_GRASP_DZ = 0.015  # the grip site this far above the can's origin: the pads on its upper half
PICK_CLOSE_STEPS = 3


def site_ik(env, s, target, robot_idx=0, site=None, target_rot=None, iters=40, lam=0.05, arm="right"):
    """Joint positions (B, na) of robot `robot_idx`'s `arm` that put `site`
    (its eef site by default) at `target` (B, 3) with its orientation at
    `target_rot` (B, 3, 3; by default its orientation at s): damped least
    squares on the plain forward kinematics, the Jacobian by forward
    differences."""
    import torch

    from robosuite_tpu_torch.physics import kinematics

    m, robot = env.model, env.robots[robot_idx]
    site = robot.eef_site_id[arm] if site is None else site
    qi = torch.as_tensor(robot.arm_qpos_idx[arm], device=s.physics.qpos.device)
    q = s.physics.qpos.clone()
    B, na = q.shape[0], len(qi)
    R0 = kinematics.fk(m, q).site_xmat[:, site] if target_rot is None else target_rot
    eps = 1e-3

    for _ in range(iters):
        qq = q[:, None].repeat(1, na + 1, 1)
        qq[:, 1:, qi] += eps * torch.eye(na, dtype=q.dtype, device=q.device)
        k = kinematics.fk(m, qq.reshape(B * (na + 1), -1))
        R = k.site_xmat[:, site].view(B, na + 1, 3, 3)
        ori = 0.5 * torch.linalg.cross(R.transpose(2, 3), R0[:, None].transpose(2, 3), dim=-1).sum(dim=2)
        e = torch.cat([target[:, None] - k.site_xpos[:, site].view(B, na + 1, 3), ori], dim=-1)  # (B, na + 1, 6)
        J = -(e[:, 1:] - e[:, :1]).transpose(1, 2) / eps                                     # (B, 6, na)
        JJt = J @ J.transpose(1, 2) + lam * lam * torch.eye(6, dtype=q.dtype, device=q.device)
        dq = (J.transpose(1, 2) @ torch.linalg.solve(JJt, e[:, 0, :, None]))[..., 0]
        q[:, qi] += torch.clamp(dq, -0.2, 0.2)
    return q[:, qi]


def pickplace_ik(env, s, target, iters=40, lam=0.05):
    """The Sawyer's arm joint positions (B, na) that put the grip site at
    `target` (B, 3) with its orientation at s unchanged (site_ik)."""
    return site_ik(env, s, target, site=env.eef_site, iters=iters, lam=lam)


def pickplace_contact_state(env, s):
    """The contact-rich PickPlace state that chip_smoke.py phases 24-25 hold
    the kernels on: the four objects resting in bin 1 where the reset put
    them, the arm moved (pickplace_ik) so that the open gripper's pads
    stand about the can's upper half, then PICK_CLOSE_STEPS policy steps
    of zero joint deltas and the gripper closing, so that the pads squeeze
    the can."""
    import torch

    from robosuite_tpu_torch.physics import kinematics

    m, robot = env.model, env.robots[0]
    q = s.physics.qpos.clone()
    can = kinematics.fk(m, q).xpos[:, env.obj_body_ids[env.object_to_id["can"]]]
    target = can + torch.tensor([0.0, 0.0, PICK_GRASP_DZ], dtype=q.dtype, device=q.device)
    q[:, torch.as_tensor(robot.arm_qpos_idx["right"], device=q.device)] = pickplace_ik(env, s, target)
    s = env.state_from_flattened(torch.cat([s.physics.time[:, None], q, torch.zeros_like(s.physics.qvel)], 1).cpu())
    a = torch.zeros(q.shape[0], env.action_dim, device=q.device)
    a[:, -1] = 1.0
    for _ in range(PICK_CLOSE_STEPS):
        s, _ = env.rollout_batch(s, a)
    return s


TWOARM_CLOSE_STEPS = 4


def gripper_columns(env):
    """{(robot index, arm): the action column of its gripper} for every
    gripper with a 1-dof action (the binary ones)."""
    out, off = {}, 0
    for i, robot in enumerate(env.robots):
        idx = robot.action_split_indexes()
        for arm in robot.arms:
            a, b = idx[f"{arm}_gripper"]
            if b - a == 1:
                out[i, arm] = off + a
        off += robot.action_dim
    return out


def _gripper_action(env, B, device, closed):
    """(B, action_dim) zeros but each binary gripper's column: +1 (closing)
    where closed(robot index, arm), else -1."""
    import torch

    a = torch.zeros(B, env.action_dim, device=device)
    for (i, arm), col in gripper_columns(env).items():
        a[:, col] = 1.0 if closed(i, arm) else -1.0
    return a


def twoarm_lift_contact_state(env, s):
    """The contact-rich TwoArmLift state that chip_smoke.py holds the
    kernels on: the pot where the reset put it, each endpoint's arm (each
    robot's, or the bimanual robot's right and left) moved (site_ik, its
    orientation kept) so that its open gripper's grip site sits at its
    handle's crossbar, then TWOARM_CLOSE_STEPS policy steps of zero arm
    deltas and both grippers closing on the bars."""
    import torch

    from robosuite_tpu_torch.envs.two_arm import _two_arm_pairs
    from robosuite_tpu_torch.physics import kinematics

    q = s.physics.qpos.clone()
    kin = kinematics.fk(env.model, q)
    for k, (i, robot, arm) in enumerate(_two_arm_pairs(env.robots)):
        target = kin.site_xpos[:, env.handle_site_ids[k]]
        q[:, torch.as_tensor(robot.arm_qpos_idx[arm], device=q.device)] = site_ik(env, s, target, robot_idx=i,
                                                                                  arm=arm)
    s = env.state_from_flattened(torch.cat([s.physics.time[:, None], q, torch.zeros_like(s.physics.qvel)], 1).cpu())
    a = _gripper_action(env, q.shape[0], q.device, lambda i, arm: True)
    for _ in range(TWOARM_CLOSE_STEPS):
        s, _ = env.rollout_batch(s, a)
    return s


# the peg's tip (the end of its axis, which the narrowphase tests as a
# capsule's end) in the hole's mouth: in the plate's plane, off the middle
# of the square between the plate's four boxes (plate frame (0.11, 0, 0),
# 0.1 wide) by PEG_SIDE along the plate's y (and x), so that the tip
# presses 1 mm into a side box (two of them)
PEG_SIDE = 0.05 - 0.015 + 0.001


def peg_contact_state(env, s):
    """The contact-rich TwoArmPegInHole state that chip_smoke.py holds the
    kernels on: robot0's arm moved (site_ik on the peg's centre site) so
    that the peg's tip stands in the hole's mouth, its axis along the
    hole's normal (from the side of the plate it faces at the reset),
    pressed against a side of the hole (+y, -y in scenarios 0 and 1 of
    every 4) or into a corner (+x +y, -x -y in scenarios 2 and 3); robot1
    as the reset put it; at rest."""
    import torch

    from robosuite_tpu_torch.physics import kinematics

    m = env.model
    q = s.physics.qpos.clone()
    kin = kinematics.fk(m, q)
    hole_pos, hole_mat = kin.xpos[:, env.plate_body_id], kin.xmat[:, env.plate_body_id]
    site = m.site_name2id("peg_center")
    R0 = kin.site_xmat[:, site]
    z = R0[..., 2]
    n = hole_mat[..., 2] * torch.sign((z * hole_mat[..., 2]).sum(-1))[:, None]  # the side the peg faces
    b = torch.arange(q.shape[0], device=q.device) % 4
    dx = torch.where(b == 2, PEG_SIDE, torch.where(b == 3, -PEG_SIDE, 0.0))
    dy = torch.where((b == 0) | (b == 2), PEG_SIDE, -PEG_SIDE)
    target = (hole_pos + (0.11 + dx)[:, None] * hole_mat[..., 0] + dy[:, None] * hole_mat[..., 1]
              - env.peg_length * n)
    # the peg's frame turned by the least rotation that takes its axis to n
    axis = torch.linalg.cross(z, n)
    sin, cos = torch.linalg.vector_norm(axis, dim=-1), (z * n).sum(-1)
    k = axis / torch.clamp_min(sin, 1e-9)[:, None]
    K = torch.zeros_like(R0)
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
    K = K - K.transpose(1, 2)
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    rot = eye + sin[:, None, None] * K + (1.0 - cos)[:, None, None] * (K @ K)
    qi = torch.as_tensor(env.robots[0].arm_qpos_idx["right"], device=q.device)
    q[:, qi] = site_ik(env, s, target, robot_idx=0, site=site, target_rot=rot @ R0, iters=80)
    return env.state_from_flattened(torch.cat([s.physics.time[:, None], q, torch.zeros_like(s.physics.qvel)], 1).cpu())


def _pointing_down(x):
    """Rotations (B, 3, 3) whose z axis is the world's -z and whose x axis
    is x (B, 3), horizontal unit vectors."""
    import torch

    z = torch.tensor([0.0, 0.0, -1.0], dtype=x.dtype, device=x.device).expand_as(x)
    return torch.stack([x, torch.linalg.cross(z, x), z], dim=-1)


NUT_SETTLE_STEPS = 4  # policy steps for the nuts to drop their 2 cm onto the table
NUT_CLOSE_STEPS = 4


def nut_contact_state(env, s):
    """The contact-rich NutAssembly state that chip_smoke.py holds the
    kernels on: NUT_SETTLE_STEPS policy steps of zero arm deltas with the
    gripper open, so that the nuts rest on the table; the arm moved
    (site_ik) so that the grip site sits at the square nut's handle, the
    gripper pointing straight down and its fingers opening across the
    handle (along the nut's y axis); then NUT_CLOSE_STEPS policy steps of
    zero arm deltas and the gripper closing on the handle."""
    import torch

    from robosuite_tpu_torch.physics import kinematics

    a = torch.zeros(s.physics.qpos.shape[0], env.action_dim, device=s.physics.qpos.device)
    a[:, -1] = -1.0
    for _ in range(NUT_SETTLE_STEPS):
        s, _ = env.rollout_batch(s, a)
    q = s.physics.qpos.clone()
    kin = kinematics.fk(env.model, q)
    target = kin.site_xpos[:, env.nut_handle_sites[0]]
    # the grip site's frame: z down, x (the fingers' opening axis) along the
    # nut's y, on the side nearer the site's x at s
    ny = kin.xmat[:, env.nut_body_ids[0], :, 1] * torch.tensor([1.0, 1.0, 0.0], dtype=q.dtype, device=q.device)
    x = ny / torch.linalg.vector_norm(ny, dim=-1, keepdim=True)
    x = x * torch.sign((x * kin.site_xmat[:, env.eef_site, :, 0]).sum(-1, keepdim=True))
    q[:, torch.as_tensor(env.robots[0].arm_qpos_idx["right"], device=q.device)] = site_ik(
        env, s, target, target_rot=_pointing_down(x), iters=60)
    s = env.state_from_flattened(torch.cat([s.physics.time[:, None], q, torch.zeros_like(s.physics.qvel)], 1).cpu())
    a[:, -1] = 1.0
    for _ in range(NUT_CLOSE_STEPS):
        s, _ = env.rollout_batch(s, a)
    return s


WIPE_PRESS = 0.001  # the wiping face this far into the table top


def wipe_contact_state(env, s):
    """The contact-rich Wipe state that chip_smoke.py holds the kernels on:
    the arm moved (site_ik) so that the wiping face, flat (the grip site's
    z straight down, its x turned about z only), presses WIPE_PRESS into
    the table top over a marker (marker b mod num_markers in scenario b),
    the arm's links clear of the table; at rest."""
    import torch

    from robosuite_tpu_torch.physics import kinematics

    q = s.physics.qpos.clone()
    B = q.shape[0]
    kin = kinematics.fk(env.model, q)
    marker = kin.xpos[:, env.marker_body_ids][torch.arange(B), torch.arange(B) % env.num_markers]
    target = marker - torch.tensor([0.0, 0.0, WIPE_PRESS], dtype=q.dtype, device=q.device)
    x0 = kin.site_xmat[:, env.eef_site, :, 0] * torch.tensor([1.0, 1.0, 0.0], dtype=q.dtype, device=q.device)
    q[:, torch.as_tensor(env.robots[0].arm_qpos_idx["right"], device=q.device)] = site_ik(
        env, s, target, target_rot=_pointing_down(x0 / torch.linalg.vector_norm(x0, dim=-1, keepdim=True)), iters=60)
    return env.state_from_flattened(torch.cat([s.physics.time[:, None], q, torch.zeros_like(s.physics.qvel)], 1).cpu())


def _grip_frame(x, xmat_g):
    """_pointing_down(x) with x (B, 3) flattened to the horizontal plane,
    normalised, and turned to the side nearer the grip site's x axis
    (xmat_g (B, 3, 3)): the fingers open along x, the gripper points down.
    Where x stands near vertical, the grip site's own x axis, flattened."""
    import torch

    flat = torch.tensor([1.0, 1.0, 0.0], dtype=x.dtype, device=x.device)
    x, xg = x * flat, xmat_g[..., 0] * flat
    x = torch.where(torch.linalg.vector_norm(x, dim=-1, keepdim=True) < 1e-3, xg, x)
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return _pointing_down(x * torch.where((x * xg).sum(-1, keepdim=True) < 0, -1.0, 1.0))


def _settle(env, s, steps):
    """`steps` policy steps of zero arm deltas with every gripper open."""
    a = _gripper_action(env, s.physics.qpos.shape[0], s.physics.qpos.device, lambda i, arm: False)
    for _ in range(steps):
        s, _ = env.rollout_batch(s, a)
    return s


def _grasp(env, s, robot_idx, target, x_axis, close_steps, iters=60, arm="right"):
    """Robot `robot_idx`'s `arm` moved (site_ik) so that its grip site sits
    at `target` (B, 3), the gripper pointing down with its fingers opening
    along the horizontal part of `x_axis` (B, 3); then `close_steps`
    policy steps of zero arm deltas, that gripper closing and the others
    open."""
    import torch

    from robosuite_tpu_torch.physics import kinematics

    q = s.physics.qpos.clone()
    robot = env.robots[robot_idx]
    site = robot.eef_site_id[arm]
    rot = _grip_frame(x_axis, kinematics.fk(env.model, q).site_xmat[:, site])
    q[:, torch.as_tensor(robot.arm_qpos_idx[arm], device=q.device)] = site_ik(
        env, s, target, robot_idx=robot_idx, target_rot=rot, iters=iters, arm=arm)
    s = env.state_from_flattened(torch.cat([s.physics.time[:, None], q, torch.zeros_like(s.physics.qvel)], 1).cpu())
    a = _gripper_action(env, q.shape[0], q.device, lambda i, a_: (i, a_) == (robot_idx, arm))
    for _ in range(close_steps):
        s, _ = env.rollout_batch(s, a)
    return s


HANDOVER_SETTLE_STEPS = 4  # the hammer drops its 1 cm onto the table and comes to rest on its head
HANDOVER_YAW_BAND = 1.0  # degrees about 45 (mod 90) where the head's landing is thrown (0.1 measured)
GRASP_CLOSE_STEPS = 6  # policy steps for a Panda gripper to close from open onto a 2-3 cm bar


def handover_contact_state(env, s):
    """The contact-rich TwoArmHandover state that chip_smoke.py holds the
    kernels on: HANDOVER_SETTLE_STEPS policy steps with both grippers open,
    so that the hammer comes to rest on the table, where a hammer placed
    within HANDOVER_YAW_BAND of 45 degrees (mod 90) about z is first
    turned 2 degrees aside (there the box-box test of its head against the
    table ties a face axis with the edge axes, and the float32 solve of
    the landing throws the hammer, in the JAX package too: ROADMAP Queue
    3); robot0's grip site moved
    to the free end of the handle, pointing down, its fingers opening
    across the handle (along the hammer's x axis); then GRASP_CLOSE_STEPS
    steps of robot0's gripper closing on it (robot1 open, as the reset put
    it). The end, not the middle: the narrowphase tests a cylinder against
    a box at the two ends of its axis (the JAX package's _capsule_box)."""
    import torch

    from robosuite_tpu_torch.physics import kinematics

    q = s.physics.qpos.clone()
    a = env.model.jnt_qpos_slice("hammer_joint0").start
    yaw = 2.0 * torch.atan2(q[:, a + 6], q[:, a + 3])  # the placement turns the hammer about z alone
    near = torch.remainder(yaw - math.pi / 4, math.pi / 2)
    near = torch.minimum(near, math.pi / 2 - near) < math.radians(HANDOVER_YAW_BAND)
    yaw = torch.where(near, yaw + math.radians(2.0), yaw)
    q[:, a + 3], q[:, a + 6] = torch.cos(yaw / 2), torch.sin(yaw / 2)
    s = env.state_from_flattened(torch.cat([s.physics.time[:, None], q, s.physics.qvel], 1).cpu())
    s = _settle(env, s, HANDOVER_SETTLE_STEPS)
    kin = kinematics.fk(env.model, s.physics.qpos)
    R = kin.xmat[:, env.hammer_body_id]
    end = kin.xpos[:, env.hammer_body_id] - 0.5 * env.hammer.handle_length * R[..., 1]  # the handle runs along y
    return _grasp(env, s, 0, end, R[..., 0], GRASP_CLOSE_STEPS)


TOOL_HANG_SETTLE_STEPS = 12  # the frame, stood on its stem, topples onto the table and comes to rest
TOOL_HANG_CLOSE_STEPS = 5  # the pads' first touch of the wrench's bar (a sixth step's squeeze throws a few)
TOOL_HANG_GRIP_DZ = 0.004  # the grip site this far above the bar's centre: the fingertips clear of the table


def tool_hang_contact_state(env, s):
    """The contact-rich ToolHang state that chip_smoke.py holds the kernels
    on: TOOL_HANG_SETTLE_STEPS policy steps with the gripper open, so that
    the stand, the frame and the wrench rest on the table; the grip site
    moved just above the wrench bar's centre, pointing down, its fingers
    opening across the bar (along the wrench's y axis); then
    TOOL_HANG_CLOSE_STEPS steps of the gripper closing onto the bar, to
    the pads' first touch: squeezing the 1.2 cm bar against the table one
    step more throws a few scenarios in 512 (the plain version too)."""
    import torch

    from robosuite_tpu_torch.physics import kinematics

    s = _settle(env, s, TOOL_HANG_SETTLE_STEPS)
    kin = kinematics.fk(env.model, s.physics.qpos)
    bar = kin.xpos[:, env.tool_body_id] + torch.tensor([0.0, 0.0, TOOL_HANG_GRIP_DZ], dtype=kin.xpos.dtype,
                                                       device=kin.xpos.device)
    return _grasp(env, s, 0, bar, kin.xmat[:, env.tool_body_id, :, 1], TOOL_HANG_CLOSE_STEPS)


LIFT_SETTLE_STEPS = 3  # the cube drops its 1 cm onto the table and rests


def lift_grasp_state(env, s, arm="right"):
    """A contact-rich Lift state for a robot with a binary gripper on `arm`
    (chip_smoke.py's Lift-Baxter phases): LIFT_SETTLE_STEPS policy steps
    with the grippers open, so that the cube rests on the table; the grip
    site moved to the cube's centre, pointing down, its fingers opening
    along the cube's x axis; then GRASP_CLOSE_STEPS steps of that gripper
    closing on the cube."""
    from robosuite_tpu_torch.physics import kinematics

    s = _settle(env, s, LIFT_SETTLE_STEPS)
    kin = kinematics.fk(env.model, s.physics.qpos)
    return _grasp(env, s, 0, kin.xpos[:, env.cube_body_id], kin.xmat[:, env.cube_body_id, :, 0], GRASP_CLOSE_STEPS,
                  arm=arm)


TRANSPORT_SETTLE_STEPS = 8  # the payload and the lid drop into and onto the start bin, the trash onto table 0


def transport_contact_state(env, s):
    """The contact-rich TwoArmTransport state that chip_smoke.py holds the
    kernels on: TRANSPORT_SETTLE_STEPS policy steps with both grippers
    open from the fixed initial poses, so that the payload rests in the
    start bin, the lid on it and the trash on table 0; robot0's grip site
    moved to the lid's handle bar, pointing down, its fingers opening
    across the bar (along the lid's y axis); then GRASP_CLOSE_STEPS
    steps of robot0's gripper closing on the bar."""
    from robosuite_tpu_torch.physics import kinematics

    s = _settle(env, s, TRANSPORT_SETTLE_STEPS)
    m = env.model
    kin = kinematics.fk(m, s.physics.qpos)
    handle = kin.geom_xpos[:, m.geom_name2id(env.lid.handle_geoms[0])]
    return _grasp(env, s, 0, handle, kin.xmat[:, env.lid_body, :, 1], GRASP_CLOSE_STEPS)


def _door(R, torch, B):
    """(Door env, its door_contact_state), or None where the tree has no
    Door env."""
    if "Door" not in R.REGISTERED_ENVS:
        return None
    env = R.make("Door", robots="Panda", reward_shaping=True, seed=0)
    s, _ = env.reset_batch(B, torch.Generator(device="cuda").manual_seed(30))
    return env, door_contact_state(env, s)


# the unfused worlds whose K1 and K2 the A/B times where the tree has them:
# (env name, make's keywords, the contact state's function name in this module)
UNFUSED = (("PickPlaceCan", dict(robots="Sawyer", controller_configs="JOINT_POSITION"), "pickplace_contact_state"),
           ("TwoArmLift", dict(robots=("Panda", "Panda")), "twoarm_lift_contact_state"),
           ("TwoArmPegInHole", dict(robots=("Panda", "Panda")), "peg_contact_state"),
           ("NutAssemblySingle", dict(robots="Panda"), "nut_contact_state"),
           ("Wipe", dict(robots="Panda", num_markers=4, seed=1,
                         controller_configs={"right": {"type": "OSC_POSE", "impedance_mode": "variable_kp"}}),
            "wipe_contact_state"),
           ("TwoArmHandover", dict(robots=("Panda", "Panda")), "handover_contact_state"),
           ("ToolHang", dict(robots="Panda"), "tool_hang_contact_state"),
           ("TwoArmTransport", dict(robots=("Panda", "Panda")), "transport_contact_state"))


def _unfused(R, torch, B):
    """{env name: (env, its contact state)} of the UNFUSED worlds the tree
    has."""
    out = {}
    for i, (name, kw, state_fn) in enumerate(UNFUSED):
        if name in R.REGISTERED_ENVS:
            env = R.make(name, reward_shaping=True, **kw)
            s, _ = env.reset_batch(B, torch.Generator(device="cuda").manual_seed(40 + i))
            out[name] = (env, globals()[state_fn](env, s))
    return out


def _states(R, engine, torch, B=512):
    """(Lift env, its contact-rich states; Stack env, its states after a
    reset and four policy steps; Door env and its contact-rich states, or
    None; the unfused worlds' envs and contact states), B scenarios each."""
    env = R.make("Lift", robots="Panda", reward_shaping=True, seed=0)
    s, _ = env.reset_batch(B, torch.Generator(device="cuda").manual_seed(0))
    for i in range(16):  # chip_smoke.py's contact-rich Lift state
        eef = env._get_observations(s.physics,
                                    engine.forward_products(env.model, s.physics.qpos, s.physics.qvel)[0])
        a = torch.zeros(B, env.action_dim, device="cuda")
        a[:, :3] = torch.clamp(-eef["gripper_to_cube_pos"] * 40.0, -1.0, 1.0)
        a[:, 6] = -1.0 if i < 12 else 1.0
        s, _ = env.rollout_batch(s, a)
    senv = R.make("Stack", robots="Panda", controller_configs="JOINT_POSITION", reward_shaping=True)
    gen = torch.Generator(device="cuda").manual_seed(20)
    ss, _ = senv.reset_batch(B, gen)
    a = torch.clamp(0.5 * torch.randn(B, senv.action_dim, generator=gen, device="cuda"), -1.0, 1.0)
    for _ in range(4):
        ss, _ = senv.rollout_batch(ss, a)
    return env, s, senv, ss, _door(R, torch, B), _unfused(R, torch, B)


def _widen(t, n):
    """n rows of t (B, ...): its first n, or copies of it."""
    B = t.shape[0]
    return t[:n].contiguous() if n <= B else t.repeat((n // B,) + (1,) * (t.dim() - 1))


def _k1_k4_cases(R, forward, engine, torch, states):
    """{name: (wrapper, args, batch)} for K1 at its widths and K4, called as
    the paths call them."""
    from robosuite_tpu_torch.ops import fk

    env, s, senv, ss, _, unfused = states
    cases = {}
    for n in K1_WIDTHS:
        args = tuple(_widen(t, n) for t in (s.physics.qpos, s.physics.qvel))
        cases[f"K1@{n}"] = (lambda q, qd, m=env.model: forward.forward_products(m, q, qd), args, n)
    for n in K1_STACK_WIDTHS:
        args = tuple(_widen(t, n) for t in (ss.physics.qpos, ss.physics.qvel))
        cases[f"K1-Stack@{n}"] = (lambda q, qd, m=senv.model: forward.forward_products(m, q, qd), args, n)
    g = torch.Generator(device="cuda").manual_seed(4)
    q4 = _widen(s.physics.qpos, max(K4_WIDTHS)).clone()
    q4[:, :7] += 0.5 * torch.randn(q4.shape[0], 7, generator=g, device="cuda")
    for n in K1_RANDOM_WIDTHS:  # distinct scenarios: random arm poses and velocities
        qr = _widen(s.physics.qpos, n).clone()
        qr[:, :7] += 0.5 * torch.randn(n, 7, generator=g, device="cuda")
        qdr = 0.2 * torch.randn(n, env.model.nv, generator=g, device="cuda")
        cases[f"K1-random@{n}"] = (lambda q, qd, m=env.model: forward.forward_products(m, q, qd), (qr, qdr), n)
    for n in K4_WIDTHS:
        cases[f"K4@{n}"] = (lambda q, m=env.model: fk.fk_pose(m, q), (q4[:n],), n)
    for name, (e, st) in unfused.items():  # the env step's width and the executed MPC step's
        for n in (512, 32):
            args = tuple(_widen(t, n) for t in (st.physics.qpos, st.physics.qvel))
            cases[f"K1-{name}@{n}"] = (lambda q, qd, m=e.model: forward.forward_products(m, q, qd), args, n)
    return cases


def _k2_k3_cases(forward, torch, states):
    """{name: (wrapper, args, batch)} for K2 and K3's four variants, and
    K2, K3 and K3-aux on Door where the tree has it."""
    from robosuite_tpu_torch.ops import contact_solve

    env, s, senv, ss, door, unfused = states
    cases = {}
    B = s.physics.qpos.shape[0]
    for e, st, tag in ((env, s, ""), (senv, ss, "-Stack")) + ((door + ("-Door",),) if door else ()):
        model, robot = e.model, e.robots[0]
        q, qd = st.physics.qpos, st.physics.qvel
        leaves = forward.runtime_leaves(model, B)
        kin = forward.forward_plain(model, q, qd, *leaves)[0]
        goal, gains = e._fused_goal_fn(robot, "right", st.ctrl, kin)
        args = (q, qd, *leaves, goal, gains, robot.gripper_ctrl("right", st.ctrl).contiguous())
        cases[f"K2{tag}@{B}"] = (contact_solve.vel_update, _k2_args(e, st, leaves, torch), B)
        if not tag:
            cases[f"K3@{B}"] = (e._fused_for(model), args, B)
            plan = model.replace(timestep=0.025, solver_iters=10, pair_points_cap=2)
            cases[f"K3-aux@{8 * B}"] = (e._fused_for(plan, emit_aux=True),
                                        tuple(t.repeat((8,) + (1,) * (t.dim() - 1)) for t in args), 8 * B)
        elif tag == "-Door":
            cases[f"K3-Door@{B}"] = (e._fused_for(model), args, B)
            plan = model.replace(timestep=0.025, solver_iters=10)
            cases[f"K3-aux-Door@{B}"] = (e._fused_for(plan, emit_aux=True), args, B)
        else:
            fused = e._fused_for(model)
            cases["K3-JP@32"] = (fused, tuple(t[:32].contiguous() for t in args), 32)
            cases[f"K3-JP@{B}"] = (fused, args, B)
            plan = model.replace(timestep=0.025, solver_iters=10)
            cases[f"K3-aux-JP@{B}"] = (e._fused_for(plan, emit_aux=True), args, B)
    for name, (e, st) in unfused.items():
        cases[f"K2-{name}@{B}"] = (contact_solve.vel_update,
                                   _k2_args(e, st, forward.runtime_leaves(e.model, B), torch), B)
    return cases


DIAG = ("-DRS_STAGE_CLOCKS",)


def _sweep_k3_defines(S):
    return tuple(f"-DRS_S_{k}={S}" for k in ("SOLVE", "SUBSTEP"))


def _k1_sweep_defines(S, F):
    return (f"-DRS_S_FORWARD={S}", f"-DRS_S_FK={F}")


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
    """Mean ms per launch of the device time of the rs_* kernel that fn
    launches (torch.profiler), free of the host's pace; over the launches
    the profiler recorded (it can miss some of a run of long kernels)."""
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if "rs_" in e.key]  # each call launches one rs_ kernel
    return sum(e.self_device_time_total for e in rows) / 1e3 / max(1, sum(e.count for e in rows))


def _host_us(torch, fn, args, reps):
    """Mean microseconds of host time per call, the launches queued and not
    waited for (the wrapper's own cost where the device keeps up)."""
    import time

    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def _time(torch, cases, out):
    """The times of every case (`<kernel>@<batch>`) into out: events,
    device, and for K1 and K4 the wrapper's host time."""
    for name, (fn, args, n) in cases.items():
        reps = 10 if n > 1024 else 50
        k = name.split("@")[0]
        out[f"{k}_ms_B{n}"] = _ms(torch, fn, args, reps)
        out[f"{k}_dev_ms_B{n}"] = _device_ms(torch, fn, args, reps)
        if k.startswith(("K1", "K4")) and n <= 4096:
            out[f"{k}_host_us_B{n}"] = _host_us(torch, fn, args, reps)


def _clock_split(torch, fn, args, read, stages):
    """Cycles of each stage of block 0's first scenario in fn's second
    launch (the diagnostic build's stamps 0 .. len(stages))."""
    clocks = (ctypes.c_longlong * 16)()
    for _ in range(2):  # the second launch is the one read
        read(clocks)
        fn(*args)
        torch.cuda.synchronize()
    if read(clocks):
        sys.exit("reading the stage clocks failed")
    c = list(clocks)
    split = {stages[i - 1]: c[i] - c[i - 1] for i in range(1, len(stages) + 1)}
    return c[len(stages)] - c[0], split


def _aux_draw_make(R, engine, forward, torch, path):
    """chip_smoke.py phase 9's K3-aux inputs at B*K=4096 for each draw of
    AUX_DRAWS, saved (on the host) to path."""
    env, s, *_ = _states(R, engine, torch)
    B, B4, nv = s.physics.qpos.shape[0], 4096, env.model.nv
    plan = env.model.replace(timestep=0.025, solver_iters=10, pair_points_cap=2)
    leaves = forward.runtime_leaves(env.model, B)
    kin = forward.forward_plain(plan, s.physics.qpos, s.physics.qvel, *leaves)[0]
    robot = env.robots[0]
    goal, gains = env._fused_goal_fn(robot, "right", s.ctrl, kin)
    args = (s.physics.qpos, s.physics.qvel, *leaves, goal, gains, robot.gripper_ctrl("right", s.ctrl).contiguous())
    out = {}
    for name, before in AUX_DRAWS.items():
        g = torch.Generator(device="cuda").manual_seed(4)
        for n, w in before:
            torch.randn(n, nv if w == "nv" else w, generator=g, device="cuda")
        a4 = [t.repeat((B4 // B,) + (1,) * (t.dim() - 1)) for t in args]
        a4[1] = a4[1].clone()
        a4[1][B:, :7] += 0.05 * torch.randn(B4 - B, 7, generator=g, device="cuda")
        out[name] = [t.cpu() for t in a4]
    torch.save(out, path)


def _min_dist64(C, model, xpos, xmat, k):
    """Pair k's minimum distance over its vertex and emitted-or-not best
    edge candidates (chip_smoke.py box_box_branches), recomputed in float64
    from geom poses xpos (N, ng, 3), xmat (N, ng, 3, 3); and the |a x b| of
    its best edge pair."""
    import torch

    def operand(g):
        return (tuple(xpos[:, g, i].double() for i in range(3)),
                [[xmat[:, g, i, j].double() for j in range(3)] for i in range(3)],
                tuple(model.geom_size[g, i].double() for i in range(3)))

    args = operand(model.pair_geom1[k]) + operand(model.pair_geom2[k])
    vertex = torch.stack([c[0] for c in C._np_box_box(*args)[:16]], dim=-1).amin(dim=-1)
    _, best_e, cands = C.box_box_sat(*args)
    seps = torch.stack([torch.where(v, sep, torch.full_like(sep, -float("inf"))) for sep, _, _, v in cands], -1)
    i, j = divmod(int(seps[0].argmax()), 3)
    a, b = (torch.stack([xmat[0, g, r, c].double() for r in range(3)]) for g, c in
            ((model.pair_geom1[k], i), (model.pair_geom2[k], j)))
    edge = torch.where(seps >= best_e[..., None] - 1e-9, seps, torch.full_like(seps, float("inf"))).amin(-1)
    return float(torch.minimum(vertex, edge)[0]), float(torch.linalg.cross(a, b).norm())


def _aux_draw_hold(R, forward, substep, torch, path, tree, this_root):
    """This tree's K3-aux on the saved inputs, held against the plain
    version; its outputs saved beside path as aux_out_<tree>.pt."""
    import importlib.util

    from robosuite_tpu_torch.physics import contact as C
    from robosuite_tpu_torch.physics import kinematics

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(this_root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    env = R.make("Lift", robots="Panda", reward_shaping=True, seed=0)
    plan = env.model.replace(timestep=0.025, solver_iters=10, pair_points_cap=2)
    fused_aux = env._fused_for(plan, emit_aux=True)
    names = ("qpos", "qvel", "f", "site_xpos", "site_xmat", "xpos", "pair_dist")
    tols = {"qpos": 1e-5, "qvel": 1e-3, "site_xpos": 2e-5, "site_xmat": 2e-5, "xpos": 2e-5}
    saved = {}
    for draw, a4 in torch.load(path).items():
        a4 = [t.cuda() for t in a4]
        out_k, out_p = fused_aux(*a4), substep.substep_aux_plain(env, plan, *a4)
        torch.cuda.synchronize()
        label = f"{tree} K3-aux ({draw} draw)"
        for name, a, b in zip(names, out_k, out_p):
            if name in tols:
                smoke.check(f"{label} {name}", smoke.max_err(a, b), tols[name])
        smoke.hold_pair_dist(label, plan, out_k[-1], out_p[-1], out_k[0], out_p[0])
        m64 = plan.replace().double()
        # what a float64-exact kernel would give: the distances recomputed in
        # float64 at the kernel's post-step qpos, held to the plain version's
        d64 = C.pair_min_dists(m64, kinematics.fk(m64, out_k[0].double()))
        smoke.hold_pair_dist(f"{label}, float64 at the kernel's qpos", plan, d64.float(), out_p[-1], out_k[0],
                             out_p[0])
        for b, k in torch.nonzero((out_k[-1] - out_p[-1]).abs() > 2e-5).tolist()[:16]:
            q = out_k[0][b:b + 1]
            kin32 = kinematics.fk(plan, q)
            kin64 = kinematics.fk(m64, q.double())
            k1 = forward.forward_products(plan, q, a4[1][b:b + 1])[0]
            d = {src: _min_dist64(C, plan, kin.geom_xpos, kin.geom_xmat, k)
                 for src, kin in (("float64", kin64), ("plain float32", kin32), ("K1", k1))}
            print(json.dumps({"tree": tree, "draw": draw, "scenario": b, "pair": k,
                              "kernel": float(out_k[-1][b, k]), "plain": float(out_p[-1][b, k]),
                              "float64 min from poses of": {src: v[0] for src, v in d.items()},
                              "best edge |a x b|": d["float64"][1]}), flush=True)
        saved[draw] = dict(zip(names, (t.cpu() for t in out_k)))
    torch.save(saved, os.path.join(os.path.dirname(path), f"aux_out_{tree}.pt"))
    print(json.dumps({"tree": tree, "failed": smoke.FAILED}), flush=True)


def _aux_draw_compare(path):
    """The two trees' K3-aux outputs on the same inputs, bit for bit."""
    import torch

    d = os.path.dirname(path)
    outs = {t: torch.load(os.path.join(d, f"aux_out_{t}.pt")) for t in ("parent", "this")}
    for draw, o in outs["this"].items():
        p = outs["parent"][draw]
        print(json.dumps({"draw": draw, "this vs parent": {
            k: {"equal": bool(torch.equal(o[k], p[k])), "max_abs_diff": float((o[k] - p[k]).abs().max()),
                "scenarios_differing": int((o[k] != p[k]).flatten(1).any(1).sum())} for k in o}}), flush=True)


def main(argv):
    me = os.path.abspath(__file__)
    if len(argv) == 3 and argv[1] == "aux-draw":
        roots = {"parent": os.path.abspath(argv[2]), "this": os.getcwd()}
        builds = [subprocess.Popen([sys.executable, me, "build", r], cwd=r) for r in roots.values()]
        if any(p.wait() for p in builds):
            sys.exit("a kernel build failed")
        path = os.path.join(roots["this"], "_archive", "aux_draw", "inputs.pt")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        subprocess.run([sys.executable, me, "aux-draw-make", roots["this"], path], check=True)
        for name in ("parent", "this"):
            subprocess.run([sys.executable, me, "aux-draw-hold", roots[name], path, name, roots["this"]],
                           cwd=roots[name], check=True)
        _aux_draw_compare(path)
        return
    if len(argv) == 2 and argv[1] not in ("split", "sweep", "sweep-k3"):
        roots = {"parent": os.path.abspath(argv[1]), "this": os.getcwd()}
        builds = [subprocess.Popen([sys.executable, me, "build", r], cwd=r) for r in roots.values()]
        if any(p.wait() for p in builds):
            sys.exit("a kernel build failed")
        for name in ("parent", "this", "this", "parent"):
            subprocess.run([sys.executable, me, "time", roots[name], name], cwd=roots[name], check=True)
        argv = [argv[0], "split"]
    if len(argv) == 2:  # split or a sweep, in a process of its own, on this tree
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
        build.build()
        return
    if mode == "aux-draw-make":
        _aux_draw_make(R, engine, forward, torch, argv[3])
        return
    if mode == "aux-draw-hold":
        _aux_draw_hold(R, forward, substep, torch, argv[3], argv[4], argv[5])
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    variants = {"split-run": [DIAG], "sweep-run": [_k1_sweep_defines(*v) for v in K1_SWEEP],
                "sweep-k3-run": [_sweep_k3_defines(S) for S in SWEEP]}.get(mode, [])
    with concurrent.futures.ThreadPoolExecutor(max(1, len(variants))) as pool:  # all builds at once
        paths = list(pool.map(lambda d: build.build(defines=d), variants))
    states = _states(R, engine, torch)
    resident = getattr(substep, "resident_per_sm", None)
    if mode == "time":
        out = {"tree": argv[3]}
        cases = {**_k1_k4_cases(R, forward, engine, torch, states), **_k2_k3_cases(forward, torch, states)}
        _time(torch, cases, out)
        if resident is not None:
            out["resident_scenarios_per_sm"] = {k: resident(fn) for k, (fn, _, _) in cases.items() if "K3" in k}
        print(json.dumps(out), flush=True)
        return
    if mode == "sweep-run":  # K1's and K4's cases in each layout, the builds in turn
        for v, path in zip(K1_SWEEP, paths):
            lib = build.load(path)
            build.library = lambda lib=lib: lib
            out = dict(zip(("k1_scenarios_per_block", "k4_scenarios_per_block"), v))
            _time(torch, _k1_k4_cases(R, forward, engine, torch, states), out)
            print(json.dumps(out), flush=True)
        return
    if mode == "sweep-k3-run":  # K2's and K3's cases in each build
        for S, path in zip(SWEEP, paths):
            lib = build.load(path)
            build.library = lambda lib=lib: lib
            cases = _k2_k3_cases(forward, torch, states)
            out = {"scenarios_per_block": S}
            _time(torch, cases, out)
            out["resident_scenarios_per_sm"] = {k: resident(fn) for k, (fn, _, _) in cases.items() if "K3" in k}
            print(json.dumps(out), flush=True)
        return
    diag = build.load(paths[0])
    for fn_name in ("rs_stage_clocks", "rs_forward_stage_clocks", "rs_fk_stage_clocks"):
        getattr(diag, fn_name).argtypes = [ctypes.c_void_p]
        getattr(diag, fn_name).restype = ctypes.c_int
    build.library = lambda: diag  # the wrappers below launch the diagnostic build
    props = torch.cuda.get_device_properties(0)
    mhz = props.clock_rate / 1e3 if hasattr(props, "clock_rate") else None
    k3 = _k2_k3_cases(forward, torch, states)
    k1 = _k1_k4_cases(R, forward, engine, torch, states)
    runs = [(n, k3[n], diag.rs_stage_clocks, STAGES[:15 if "aux" in n else 14])
            for n in ("K3@512", "K3-aux@4096", "K3-JP@32", "K3-aux-JP@512", "K3-Door@512", "K3-aux-Door@512")]
    runs += [(n, k1[n], diag.rs_forward_stage_clocks, K1_STAGES)
             for n in ("K1@512", "K1@335872", "K1-Stack@512")]
    runs += [(n, k1[n], diag.rs_fk_stage_clocks, K4_STAGES) for n in ("K4@8192", "K4@32768")]
    for name, (fn, args, n), read, stages in runs:
        total, split = _clock_split(torch, fn, args, read, stages)
        print(json.dumps({"case": name.split("@")[0], "B": n, "total_cycles": total,
                          "total_us_at_max_clock": total / mhz if mhz else None, "cycles": split,
                          "share": {k: round(v / total, 4) for k, v in split.items()}}), flush=True)


if __name__ == "__main__":
    main(sys.argv)
