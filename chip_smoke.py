#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (robosuite_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels (csrc/*.cu, nvcc for sm_90a);
  3. make("Lift", robots="Panda", reward_shaping=True) on CUDA and
     reset_batch(512) — the batch of bench.py's env-step workload;
  4. K1 (forward products) against its plain version on those states, with
     the model's leaves at batch stride 0 (as the paths pass them) and with
     contiguous ones; timed by events and by the profiler's device time;
  5. K2 (contact solve) against its plain version on operands the plain
     path forms at a contact-rich state (the arm driven down onto the
     cube, fingers closing), with at least 4 active contact rows;
  6. K3 (fused substep) against its plain version at that state;
  7. the slice: launch counts zeroed, reset_batch(512) + 10 policy steps of
     rollout_batch with small random deltas; finite states and rewards;
     K3 = 25 launches per step, K1 = 2 per step + 1 for the reset; one
     policy step of the kernel path against the plain path; one step with
     the fused path disabled, which must run through K1 and K2;
  8. K1 at random arm poses at 32, 128 and 4096 (Stack's executed step,
     the iLQR rollouts, the MPPI start) against its plain version, timed at
     128 and 4096; K4 (pose-only FK) against its plain version at B=4096
     and at the MPC path's widths (128, 512, 8192, 32768), timed at 8192
     and 32768;
  9. K3's emit_aux variant against its plain version at the contact-rich
     state on the 2-point planning model (dt 25 ms, 10 solver iterations),
     at B=512 and at the MPPI width B*K=4096 (two draws of its velocity
     offsets); pair distances in every scenario, a mismatch set aside only
     with a float64 witness that it is a SAT near-tie or an ill-conditioned
     edge separation that the kernel has within tolerance of float64
     (hold_pair_dist);
 10. the MPC planning hooks, kernel path against the plain path: the
     planning returns of make_plan_return on a subset (8 solves x 32
     samples, H=8), and the forward-difference sweep of make_plan_dynamics
     at full width (B*H*(1+nx+nu) = 335,872 scenarios, one K1 and one K3
     launch) against the plain path on a strided sample of its rows
     (before the division by eps); then K1 alone on the sweep's states at
     full width against its plain version on those rows, and timed;
 11. the MPC slice at bench.py's width (B=128, H=64, K=32, MPPI + 1 iLQR
     iteration, relinearized every 4th tick): a warm-up tick, then ticks
     1-4 timed on the host clock, with the launches per tick the config
     implies, finite actions in [-1, 1] and the peak device memory (the
     profiler pass over one more tick cut for the run's time in PR 15);
 12. make("Stack", robots="Panda", controller_configs="JOINT_POSITION") on
     CUDA, reset_batch(512): K1 against its plain version at B=512 and 32,
     and timed at both;
     a contact-rich state (cubeA dropped onto cubeB in every other
     scenario, four steps to land);
 13. K2 against its plain version at Stack's width (nv 21, 96 rows);
 14. K3's JOINT_POSITION branch (K3-JP) at B=512 and 32, and its emit_aux
     variant (K3-aux-JP) at B*K=512 on the planning model, against their
     plain versions: the robot in every scenario, the cubes in every
     scenario but those with a float64 witness of a contact near-tie
     (hold_cubes), the aux poses and pair distances at the kernel's own
     post-step qpos;
 15. the Stack env-step slice: counts zeroed, reset + 10 policy steps
     (K1 = 21, K3-JP = 250 launches), the host-clock rate with the reset
     (the steady rate and the profiled step cut for the run's time);
     every substep of the 10 steps against the plain
     substep from the same input; one step with the fused path disabled
     (K1 + K2), substep by substep against the fused one;
 16. the Stack MPC at tools/bench_configs.py's width (B=32, H=128, K=16,
     MPPI only, 2 substeps per planned step): a warm-up tick, ticks 1-3
     timed with their launch counts, finite actions in [-1, 1] and peak
     memory (the profiled tick cut in PR 15);
 17. (after phase 7) Lift's step_batch, the RL entry point, at B=512: counts
     zeroed, reset + 3 policy steps (K1 = 7, K3 = 75); then each step
     against rollout_batch from the same input: the same states and
     rewards bit for bit, finite observations, done False, the reset's
     observation keys;
 18. make("Door", robots="Panda", reward_shaping=True, seed=0) on CUDA
     (nq 11, 60 pairs, 170 rows), reset_batch(512): K1 against its plain
     version at B=512 and 32, timed; a contact-rich state
     (ab_kernels.door_contact_state: the gripper driven over the handle,
     down onto it and closing on it, then the hinge past its upper limit,
     below its lower one, the latch near +1.57 and near -1.57 in one
     scenario in 8 each), which must reach rows past 96 (box-box, above
     the maxima before Door) in half the scenarios and have 4 active rows
     or more in half;
 19. K2 against its plain version at Door's width (nv 11, 170 rows);
 20. K3 (B=512) and K3-aux (B*K=512, the planning model: dt 25 ms, 10
     solver iterations) against their plain versions at that state: every
     coordinate and the solver forces of every scenario but those with a
     float64 witness of a box-box contact near-tie (hold_all), the aux
     poses, and the pair distances of every pair of every scenario
     (hold_pair_dist's witnesses);
 21. the Door step slice: counts zeroed, reset + 10 step_batch policy
     steps (K1 = 21, K3 = 250), finite observations, rewards and done,
     the host-clock rate with the reset (the steady rate and the profiled
     step cut for the run's time); each policy step against the plain
     path from the same input; one unfused step (K1 + K2);
 22. the Door MPC at tools/bench_configs.py's width (B=32, H=64, K=16,
     MPPI only): a warm-up tick, ticks 1-3 timed with their launch counts,
     finite actions in [-1, 1] and peak memory (the profiled tick cut in
     PR 15);
 23. make("PickPlaceCan", robots="Sawyer", controller_configs=
     "JOINT_POSITION", reward_shaping=True) on CUDA (nq 37, nv 33, 40
     bodies, 105 geoms, 606 pairs, 1326 candidate points), reset_batch(512):
     the fused substep's gate refuses the world for its row compaction;
     K1's and K2's shared memory a block; K1 against its plain version at
     B=512 and 32, timed;
 24. a contact-rich state (ab_kernels.pickplace_contact_state: the arm
     moved so that the open pads stand about the can, the gripper closing
     on it, the objects resting in bin 1), at least 4 active rows in half
     the scenarios; the active rows' median and maximum and the scenarios
     where the 96-slot cap drops rows;
 25. K2 against its plain version at nv 33 and 96 compacted slots; the
     contact rows' CUDA graph (C.contact_rows) against the eager code, bit
     for bit, at the reset and the contact state (B=512);
 26. the step slice on the unfused path: counts zeroed, reset (the
     scenarios whose placement the reset flags invalid drawn again,
     valid_resets; K1 = one a reset_batch call) + 10 step_batch policy
     steps (K1 = 27 a step, K2 = 25 a step, K3 = 0), finite observations,
     rewards and done, the eef wrench zero, the host-clock rate with the
     reset (every world from PickPlaceCan to TwoArmTransport runs cut in
     depth: no steady rate, no profiled step or MPC tick); the first
     policy steps (EARLIER_HELD, 2) substep by substep, every K1 and K2 launch against its
     plain version on its own operands (a K2 scenario set aside only on
     solve_conditioning_witness), the kernel substep (K1 + K2) and the
     plain one from the same input under hold_all's rule (with
     pose_rounding_witness), the last substep being step_batch's next state
     bit for bit, and the count of cases set aside;
 27. the PickPlaceCan MPC at tools/bench_configs.py's width (B=32, H=128,
     K=16, MPPI only, unfused planning rollouts): a warm-up tick, tick 1
     timed with its launch counts (ticks 1-3 until the NutAssembly and
     Wipe phases took their time), finite actions in [-1, 1], peak memory
     and a profiled tick; the planning rollouts' rows graph (B K =
     512, dt 0.025) against the eager code, bit for bit, as in 25;
 28-32. make("TwoArmLift", robots=("Panda", "Panda"), env_configuration=
     "opposed", reward_shaping=True) on CUDA (nq 25, nv 24, 47 bodies, 170
     geoms, 19 sites, 18 actuators, 170 pairs, 620 rows compacted into 96
     slots), the first world past the single-arm maxima, unfused (the fused
     gate refuses two robots, as the JAX package's does): 28, the world,
     the gate, K1's and K2's shared memory a block, K1 against its plain
     version at B=512, 32 and 1, timed at 512 and 32; 29, a contact-rich
     state (ab_kernels.twoarm_lift_contact_state: both grippers closed on
     their handles, in half the scenarios at least, with 4 active rows or
     more); 30, K2 at nv 24 and 96 slots against its plain version, the
     rows' CUDA graph against the eager code at the reset and that state;
     31, counts zeroed, reset + 10 step_batch policy steps (K1 = 27 a step,
     K2 = 25 a step), finite observations and rewards, a proprio modality
     per robot, host-clock rates with the reset and over 10 more steady
     steps, a profiled step, and the first steps' substeps held as in 26,
     with the count of cases set aside; 32, the MPC at tools/bench_configs.py's
     width (B=32, H=64, K=16, MPPI only) as in 27;
 33-37. the same for make("TwoArmPegInHole", ...) (nq 14, nv 14, 40
     bodies, 136 geoms, 39 pairs, 117 static rows; the peg and the plate
     welded at the eefs): its contact state (ab_kernels.peg_contact_state:
     the peg's tip pressed into a side of the hole's mouth, an active row
     in three quarters of the scenarios at least), K2 at nv 14 and 117
     static rows.
 38-43. make("NutAssemblySingle", robots="Panda", reward_shaping=True) on
     CUDA (nq 23, nv 21, 31 bodies, 104 geoms, 20 sites, 186 pairs, 680
     rows compacted into 96 slots), unfused (the fused gate refuses its
     row compaction, as the JAX package's does): 38, the world and the
     gate; 39, K1's and K2's shared memory a block, K1 against its plain
     version at B=512 and 32, timed; 40, a contact-rich state
     (ab_kernels.nut_contact_state: the nuts resting on the table, the
     gripper closed on the square nut's handle, grasping it in half the
     scenarios at least, 4 active rows or more in half), the active rows'
     median and maximum and the scenarios where the 96-slot cap drops rows;
     41, K2 at nv 21 and 96 slots against its plain version, the rows' CUDA
     graph against the eager code at the reset and that state; 42, counts
     zeroed, reset + 10 step_batch policy steps (K1 = 27 a step, K2 = 25 a
     step, K3 = 0), finite observations, rewards and done, host-clock rates
     with the reset and over 10 more steady steps, a profiled step, the
     first steps' substeps held as in 26 and the count of cases set aside;
     43, the
     MPC at tools/bench_configs.py's width (B=32, H=64, K=16, MPPI only) as
     in 27, with tick 1 timed;
 44-49. the same for make("Wipe", robots="Panda", controller_configs=
     {"right": {"type": "OSC_POSE", "impedance_mode": "variable_kp"}},
     num_markers=4, seed=1) (nq 7, nv 7, 25 bodies, 116 geoms, 175 pairs,
     448 rows compacted into 96 slots; the wiping gripper, 12-wide
     actions): its contact state (ab_kernels.wipe_contact_state: the
     wiping face pressed 1 mm into the table over the markers, the arm
     clear of it), K2 at nv 7; the step slice's episodes may end early (an
     unsafe step, every marker wiped) and it prints the share of scenarios
     done early, unsafe and with a marker wiped; the reward held is the
     step hook's (_step_hook) on the plain poses;
 51-55. the same for make("TwoArmHandover", robots=("Panda", "Panda"),
     env_configuration="opposed") (nq 25, nv 24, 47 bodies, 161 geoms, 17
     sites, 62 pairs, 203 rows compacted into 96 slots; the fused gate
     refuses two robots): K1 at B=512, 32 and 1, its contact state
     (ab_kernels.handover_contact_state: robot0's pads closed on the end
     of the hammer's handle, both pads on it in half the scenarios at
     least), K2 at nv 24, the step slice and one timed MPC tick;
 56-60. the same for make("ToolHang", robots="Panda") (nq 30, nv 27, 28
     bodies, 102 geoms, 14 sites, 172 pairs, 656 rows into 96 slots; its
     reward is sparse, so its planning returns are zero unless a sample
     succeeds): K1 at 512 and 32, its contact state (ab_kernels.
     tool_hang_contact_state: the stand, the frame and the wrench at rest
     on the table, the pads closed on the wrench's bar; 8 active rows or
     more and a pad on an object in half the scenarios), K2 at nv 27;
 61-65. the same for make("TwoArmTransport", robots=("Panda", "Panda"))
     (nq 39, nv 36, 53 bodies, 170 geoms, 23 sites, 250 pairs, 905 rows
     into 96 slots: K1 past its earlier body maximum, K2 at its dof
     maximum nv 36): K1 at 512, 32 and 1, its contact state (ab_kernels.
     transport_contact_state: the payload in the start bin under the lid,
     the trash on table 0, at rest, robot0's pads closed on the lid's
     handle; 8 active rows or more in half the scenarios), K2 at nv 36
     (its block's shared memory printed beside K1's);
 50. (last) a fused world with the variable_kp OSC (Lift): K3 against its
     plain version with each scenario's own gains from its action (the
     goal and gains rows of envs/base._fused_goal_fn).
 66-70. the kernels' tangent rules and the iLQR's AD linearization:
     after phases 9, 14 and 34 (Lift, Stack, TwoArmPegInHole contact
     states, 64 scenarios) each of K1Function, K2Function and, on the
     fused worlds, K3Function with and without aux: its primal the direct
     launch's bit for bit, its tangents within TANGENT_TOL of
     torch.func.jvp of the plain version; fk_pose refusing a dual qpos;
     after phase 11 (Lift, B=32, H=64, K=32) and phase 37
     (TwoArmPegInHole, B=32, H=64, K=16, nx 30) the MPC with one iLQR
     iteration relinearized every tick by forward differences and by
     forward-mode AD (ad_mpc, AD_TICKS timed ticks each, 2 until PR 15:
     the associative Riccati pass, launches,
     solves/s, peak memory, the tangent pass's share and passes, the AD
     fx/fu against forward differences, the associative gains against
     the sequential pass); and the one-scenario make_solve on Lift against
     solve_batch at B=1 (unbatched_tick).
 71-80. the remaining arm controllers (controllers_slice), last: 71-74,
     Lift-Panda with IK_POSE, unfused as the JAX gate decides (K1, the 66
     static rows' CUDA graph, K2): the gate, K1 at B=512 and 32, counts
     zeroed, reset + 10 step_batch steps with the first EARLIER_HELD held
     substep by substep (cut from all 10 for the run's time; no steady
     rate or profiled step since the wheeled and legged worlds), K2 at nv
     15 and 66 static rows at the last step's state (the cube resting: 4
     active rows), one MPPI tick (B=32, H=64, K=16; not profiled) and one
     tick with an iLQR iteration linearized by forward differences (83,968
     scenarios in the sweep; its profile cut in PR 15), each with the launches its config
     implies; 75, Lift-Panda OSC_POSITION,
     fused (K3): reset + 10 step_batch steps, each held substep by substep
     against the plain path (hold_all's rule: a free cube's row decision
     that float32 rounding takes either way diverges over a whole step),
     its orientation goal the eef's, 10 steady steps, one MPPI tick
     through K3-aux; 76-80, reset + EARLIER_HELD steps held substep by
     substep (the fused ones under hold_all's rule, with a goal row a
     substep under interpolation), no steady rate: Lift OSC_POSE with
     linear goal interpolation, Door OSC_POSE with absolute world-frame
     goals (fused), Lift JOINT_VELOCITY and JOINT_TORQUE, Sawyer-Lift
     IK_POSE (unfused, its rows compacted into 96 slots).
 81-92. the robots that need no new physics (robots_slice): 81,
     Lift-PandaDexRH (nq 26, nv 25; an Inspire hand: a 6-wide action on
     12 position actuators, K3's gripper maximum 12), fused: K3's and
     K3-aux's carve (rs_substep_smem_bytes, rs_substep_resident), reset +
     10 rollout_batch steps with the first EARLIER_HELD held substep by
     substep, 10 steady steps, one K3 launch held at the last state; one
     MPC tick at bench.py's Lift shape (B=128, H=64, K=32, an FD iLQR
     iteration every tick: a 622,592-scenario sweep) with its launches,
     then K3-aux at B*K=4096, K4 at 128 and 8192 and K1 at the sweep's
     width held against their plain versions, K1 timed there; 82,
     Lift-SpotArm (6 arm dofs, the BD gripper), fused: reset +
     EARLIER_HELD step_batch steps held, one K3 launch held, one MPPI tick
     (B=32, H=64, K=16); 83-84, Stack-PandaDexLH (nv 31, the widest fused
     carve) and Door-PandaDexRH (24 sites, plane-cylinder and
     cylinder-cylinder pairs): the carve, one K3 and one K3-aux launch at
     B=512 at a state in contact (the PandaDex hands touch nothing: the
     cubes stacked, the latch against the frame) against their plain
     versions; 85-92, Baxter (bimanual, unfused: the gate refuses it as
     multi-arm) on Lift, on TwoArmLift and on TwoArmTransport in the
     "single-robot" configuration (351, 761 and 1,179 candidate pairs
     compacted into 96 slots): each world's contact state (ab_kernels.
     lift_grasp_state, twoarm_lift_contact_state, transport_contact_state)
     and its contact rows graph (rows_graph_report: a fresh capture's
     time, the replay's time at B=512, the device activities of one eager
     run and of one replay), K2 (nv 24 or 36, 96 slots) against its plain
     version and the graph against the eager rows; Lift-Baxter also K1 at
     512 and 32, reset + 10 step_batch steps with the first EARLIER_HELD
     held substep by substep (robot0_left_eef_force present and zero) and
     one MPPI tick; TwoArmLift-Baxter reset + EARLIER_HELD steps, all
     held; TwoArmTransport-Baxter one K1 and one K2 launch at its contact
     state.
 93-105. the tendon and equality worlds and the wide ones (tendons_slice),
     all unfused: Lift with UR5e (Robotiq 85: spring tendons; K1 at 512
     and 32, K2 at the settled state, reset + 10 step_batch steps with the first
     EARLIER_HELD held, one MPPI tick at B=32, H=64, K=16, one tick with
     an FD-linearized iLQR iteration; its steady rate, profiled step and
     profiled ticks cut since the wheeled and legged worlds), XArm7 (a `general` servo on a tendon, 7
     connect and joint rows; K1 at 512, K2 with its rows at the grasp
     state, reset + 10 steps with EARLIER_HELD held, one MPPI tick), IIWA
     (4 tendon rows) and Jaco (3 tendon rows, 96 slots; K2 with its rows at
     the grasp state, reset + EARLIER_HELD steps held), Kinova3 (K2 at the
     settled state, reset + EARLIER_HELD steps held), each refused by the
     fused gate for its tendons and with its carves printed; the UR5e,
     Kinova3, IIWA and XArm7 substeps held launch by launch
     (TENDON_WORLDS), Jaco's whole; then PickPlaceCan and
     NutAssemblySingle with Baxter and with PandaDexRH (nq up to 47, nv up
     to 43, up to 31 sites: the raised maxima): K1 at 512, reset +
     EARLIER_HELD step_batch steps held, K2 at their last state, and one
     MPPI tick on PickPlaceCan-Baxter.
 106-115. the wheeled and legged robots (mobile_slice), last, unfused (the
     fused gate refuses a mobile robot, and Tiago's tendons first, as the
     JAX gate does): each world's runtime (MobileRobot, LeggedRobot), its
     action layout and the gate, K1's and K2's carves, K1 at 512 against
     its plain version and timed, K2 at the settled state (the cube at
     rest, Spot on its feet) against its plain version and timed; then
     Lift-PandaOmron (HYBRID_MOBILE_BASE: the base's joint velocities, the
     torso lift, the base-mode flag; reset + 10 step_batch steps with the
     first EARLIER_HELD held substep by substep, one MPPI tick at B=32,
     H=64, K=16; the steady rate and the profiled step cut for the run's
     time),
     Lift-SpotWithArm
     (a free root beside the cube's, 12 legs on Spot's raw servo; 10
     steps with EARLIER_HELD held, one MPPI tick), Lift-SpotWithArmFloating
     (reset + EARLIER_HELD steps held), Lift-Tiago (60 bodies, 31 joints:
     K1's raised maxima; K1 also at 32; reset + EARLIER_HELD steps held
     launch by launch, its Robotiq 85s as the UR5e's) and Lift-PandaOmron
     under WHOLE_BODY_IK (default_pandaomron_whole_body_ik.json: absolute
     targets about the reset's eef pose; reset + EARLIER_HELD steps held).
 116-125. GR1 and its three variants (gr1_slice), last, unfused (the fused
     gate refuses a non-fixed-base robot): Lift-GR1 (WHOLE_BODY_IK over the
     torso and both arms, 12 actuated legs anchored to the card's stance,
     the Fourier hands; 92 bodies, nv 60, 558 pairs compacted into 96
     slots), Lift-GR1FixedLowerBody (WHOLE_BODY_MINK_IK run as
     WHOLE_BODY_IK), Lift-GR1FloatingBody (HYBRID_MOBILE_BASE) and
     Lift-GR1ArmsOnly: each world's runtime, action layout and gate, K1's
     and K2's blocks (K1 2 scenarios a block where 4 do not fit the card,
     K2 at nv 60 one), K1 at 512 against its plain version and timed, K2 at
     the settled state (the arms held at their poses) against its plain
     version and timed, reset + 10 step_batch steps (WHOLE_BODY_IK:
     absolute targets about the reset's eef poses) with the first
     EARLIER_HELD held substep by substep; on Lift-GR1 also K1 at 32, K4
     once at 512 held against its plain version, the steady rate and a
     profiled step, the stance (8 zero-action policy steps keep the torso
     within 0.15 m of its height) and one MPPI tick at B=32, H=64, K=16.
The count of (substep, scenario) cases that the holds set aside on a
float64 near-tie witness is printed at the end.
Timings use CUDA events (profiler passes show one policy step's and one
MPC tick's device time; K1's and K4's widths also print the profiler's
kernel device time, and, at the end, each width's launches over the
paths); every number is printed beside the card's name
and power limit, which the first line gives. TF32 is off, so the plain
versions are float32 references. Each phase prints its seconds. The line
before the last is one JSON object listing the kernels (launches: the
sum over the paths that run each, every path counted from zero); the last
line is
{"ok": true, "device": {...}}. A JSON copy of the results goes to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
B = 512
STEPS = 10
SEED = 0

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, float32 and float64
# non-tensor rates
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_FP64_FLOP_PER_S = 34e12


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean ms per call by CUDA events, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps):
    """Mean ms per launch of the device time of the rs_* kernel fn launches
    (torch.profiler's kernel time, free of the host's pace), after one
    warm-up call; over the launches the profiler recorded (it can miss
    some of a run of long kernels); NaN where three profiled runs recorded
    none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # now and then the profiler records none of a run's launches: profile again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if "rs_" in e.key]  # each call launches one rs_ kernel
        n = sum(e.count for e in rows)
        if n:
            return sum(e.self_device_time_total for e in rows) / 1e3 / n
    return float("nan")


def time_width(tag, label, fn, plain, reps, bytes_, flops, n):
    """One kernel at one width: events and device time, bound, the plain
    version's events time; printed, -> a dict for the results."""
    ev, dev = cuda_ms(fn, reps), device_ms(fn, reps)
    bms, bby = bound(bytes_, flops, n)
    pms = cuda_ms(plain, 1 if n > 100000 else 3)
    share = f"{100 * bms / dev:.1f}% of the device time" if dev > 0 else "device time not recorded"
    print(f"{tag} {label} B={n}: {ev:.4f} ms by events, {dev:.4f} ms device time (profiler), bound {bms:.5f} ms "
          f"({bby}, {share}), plain {pms:.3f} ms")
    return dict(B=n, ms=ev, dev_ms=dev, bound_ms=bms, bound_by=bby, plain_ms=pms)


def hold_k1(label, model, q, qd, leaves=None):
    """K1 against its plain version on (q, qd) (leaves: the model's own,
    batch stride 0, as the paths pass them, unless given): poses 2e-5 (the
    float32 rounding of chains of ~26 rotations, |x| <= 3 m), M 1e-5 and
    bias 1e-4 relative to their largest entry (the kernel sums in double,
    the plain version in float32). -> the largest absolute error."""
    import torch
    from robosuite_tpu_torch.ops import forward

    kin_k, M_k, bias_k = forward.forward_products(model, q, qd, *(leaves or ()))
    kin_p, M_p, bias_p = forward.forward_plain(model, q, qd, *(leaves or forward.model_leaves(model, q.shape[0])))
    torch.cuda.synchronize()
    fields = [f for f, v in kin_p.__dict__.items() if v is not None]
    pose_err = max(max_err(getattr(kin_k, f), getattr(kin_p, f)) for f in fields)
    check(f"{label} poses", pose_err, 2e-5)
    check(f"{label} M (relative)", max_err(M_k, M_p) / max(1.0, float(M_p.abs().max())), 1e-5)
    check(f"{label} bias (relative)", max_err(bias_k, bias_p) / max(1.0, float(bias_p.abs().max())), 1e-4)
    return max(pose_err, max_err(M_k, M_p), max_err(bias_k, bias_p))


def k1_bytes(model, n):
    """Bytes K1 must move for n scenarios: qpos and qvel read, the model's
    leaves read once (batch stride 0), the 13 outputs written."""
    nq, nv, nb, ng, ns = model.nq, model.nv, model.nbody, model.ngeom, model.nsite
    per = (nq + nv) + 3 * nb + 4 * nb + 9 * nb + 12 * ng + 12 * ns + 6 * nv + nv * nv + nv + 12 * nb
    return 4 * (n * per + nb + 3 * nb + 3 + nv)


WIDTHS = []  # (world, {kernel: {batch: launches}}) of each path, counted from zero


def clear_widths():
    from robosuite_tpu_torch.ops import fk, forward

    forward.forward_products.by_batch.clear()
    fk.fk_pose.by_batch.clear()


def take_widths(world):
    """Record the launches of K1 and K4 by batch size since clear_widths."""
    from robosuite_tpu_torch.ops import fk, forward

    WIDTHS.append((world, {"K1": dict(forward.forward_products.by_batch), "K4": dict(fk.fk_pose.by_batch)}))


def kcounts():
    """Every kernel wrapper's launch count."""
    from robosuite_tpu_torch.ops import contact_solve, fk, forward, substep

    return {"K1": forward.forward_products.launches, "K2": contact_solve.vel_update.launches,
            "K3": substep.make_fused_substep.launches, "K3-aux": substep.make_fused_substep.aux_launches,
            "K4": fk.fk_pose.launches}


def zero_counts():
    from robosuite_tpu_torch.ops import contact_solve, fk, forward, substep

    forward.forward_products.launches = contact_solve.vel_update.launches = 0
    substep.make_fused_substep.launches = substep.make_fused_substep.aux_launches = fk.fk_pose.launches = 0
    clear_widths()


def max_err(a, b):
    return float((a - b).abs().max())


FAILED = []
ASIDE = []  # the label of each (substep, scenario) case a hold set aside on a float64 witness


def check(name, err, tol):
    """Record a comparison; a disagreement fails the run at its end (so one
    run reports every comparison)."""
    ok = err <= tol
    print(f"{name}: max_abs_err {err:.3e} (tolerance {tol:.3e}){'' if ok else '  <-- FAILED'}")
    if not ok:
        FAILED.append(name)


def spread(label, a, b):
    """Print the spread over scenarios of the per-scenario max |a - b|."""
    import torch

    e = (a - b).abs().amax(dim=1)
    q50, q99 = (float(x) for x in torch.quantile(e, torch.tensor([0.5, 0.99], device=e.device)))
    worst = int((a - b).abs().amax(dim=0).argmax())
    print(f"{label} over scenarios: median {q50:.3e} p99 {q99:.3e} max {float(e.max()):.3e} "
          f"(worst coordinate {worst})")


def hold_step(label, state, qpos, qvel):
    """Compare a policy step's state with (qpos, qvel): robot coordinates in
    every scenario, all coordinates at the 99th percentile of scenarios."""
    import torch

    nr = 9  # 7 arm + 2 finger joints come first in qpos and qvel
    check(f"{label} robot qpos", max_err(state.physics.qpos[:, :nr], qpos[:, :nr]), 1e-4)
    check(f"{label} robot qvel", max_err(state.physics.qvel[:, :nr], qvel[:, :nr]), 1e-3)
    for name, a, b, tol in (("qpos", state.physics.qpos, qpos, 1e-5), ("qvel", state.physics.qvel, qvel, 1e-4)):
        spread(f"{label} {name}", a, b)
        e = (a - b).abs().amax(dim=1)
        n_over, n_allowed = int((e > tol).sum()), int(e.numel() * 0.01)
        print(f"{label} {name}: {n_over} of {e.numel()} scenarios past {tol:.0e} (the p99 check allows about "
              f"{n_allowed})")
        check(f"{label} {name} p99 over scenarios", float(torch.quantile(e, 0.99)), tol)


def box_box_branches(model, qpos, k):
    """Box-box pair k at qpos (N, nq), recomputed in float64: (the SAT tie
    margin best_e - max_face, the pair's minimum distance over its 16 vertex
    candidates alone, and over those and the best edge-cross candidates),
    the two values its minimum distance takes on either side of the tie."""
    import torch
    from robosuite_tpu_torch.physics import contact as C
    from robosuite_tpu_torch.physics import kinematics

    m64 = model.replace().double()
    kin = kinematics.fk(m64, qpos.double())

    def operand(g):
        return (tuple(kin.geom_xpos[:, g, i] for i in range(3)),
                [[kin.geom_xmat[:, g, i, j] for j in range(3)] for i in range(3)],
                tuple(m64.geom_size[g, i] for i in range(3)))

    args = operand(model.pair_geom1[k]) + operand(model.pair_geom2[k])
    vertex = torch.stack([c[0] for c in C._np_box_box(*args)[:16]], dim=-1).amin(dim=-1)
    max_face, best_e, cands = C.box_box_sat(*args)
    edge = torch.stack([torch.where(valid & (sep >= best_e - 1e-9), sep, torch.full_like(sep, float("inf")))
                        for sep, _, _, valid in cands], dim=-1).amin(dim=-1)
    return best_e - max_face, vertex, torch.minimum(vertex, edge)


def hold_pair_dist(label, model, pd_k, pd_p, qpos_k, qpos_p, tol=2e-5, tie=1e-5):
    """Hold per-pair minimum distances (B, npair) to the plain version's in
    every scenario. A (scenario, box-box pair) beyond `tol` passes only
    with one of two float64 witnesses, recomputed at both versions'
    post-step qpos; every case is printed. (1) A near-tie: a box-box pair
    emits an edge-cross candidate only where its best edge separation beats
    every face separation; where the two tie within the float32 rounding of
    the two versions' poses, they can decide differently, and the minimum
    jumps between two values. The witness: the tie margin within `tie` at
    both qpos, and the two values each within `tol` of a different side.
    (2) An ill-conditioned edge: an edge-cross separation divides by |a x
    b| of two edges, so for nearly parallel edges the float32 rounding of
    the poses moves it by more than `tol` in either version. The witness:
    the kernel's value within `tol` of the float64 distance at its own
    qpos, and the float64 distances at the two qpos within `tol` of each
    other (the plain version's own float32 error is the rest). -> the
    largest error held (the witnessed cases set aside)."""
    import torch

    from robosuite_tpu_torch.models import spec as S

    err = (pd_k - pd_p).abs()
    bad = torch.nonzero(err > tol).tolist()
    ties = exact = 0
    if len(bad) <= 64:
        for b, k in bad:
            dk, dp = float(pd_k[b, k]), float(pd_p[b, k])
            if model.geom_type[model.pair_geom1[k]] != S.BOX or model.geom_type[model.pair_geom2[k]] != S.BOX:
                print(f"{label} scenario {b} pair {k}: kernel {dk:.6e} plain {dp:.6e}, not a box-box pair")
                continue
            mk, vk, ek = (float(x[0]) for x in box_box_branches(model, qpos_k[b:b + 1], k))
            mp, vp, ep = (float(x[0]) for x in box_box_branches(model, qpos_p[b:b + 1], k))
            flip = (abs(mk) <= tie and abs(mp) <= tie
                    and ((abs(dk - vk) <= tol and abs(dp - ep) <= tol) or (abs(dk - ek) <= tol and abs(dp - vp) <= tol)))
            d64k, d64p = (ek if mk > 0 else vk), (ep if mp > 0 else vp)  # the float64 distance at each qpos
            f64 = not flip and abs(mk) > tie and abs(mp) > tie and abs(dk - d64k) <= tol and abs(d64k - d64p) <= tol
            print(f"{label} scenario {b} pair {k}: kernel {dk:.6e} plain {dp:.6e}; float64 tie margin, vertex-only "
                  f"and with-edge minimum at the kernel's qpos {mk:.3e} {vk:.6e} {ek:.6e}, at the plain's qpos "
                  f"{mp:.3e} {vp:.6e} {ep:.6e}; kernel - float64 {dk - d64k:.3e}, plain - float64 {dp - d64p:.3e}: "
                  + ("a near-tie decided differently" if flip else
                     "the kernel agrees with float64, the plain version's float32 error" if f64 else "NOT witnessed"))
            if flip or f64:
                err[b, k] = 0.0
                ties += flip
                exact += f64
    check(f"{label} pair_dist, every scenario ({ties} witnessed near-ties, {exact} witnessed float64 agreements "
          f"set aside)", float(err.max()), tol)
    return float(err.max())


def op_counts(model, nrows, nact=0.0, iters=30, power_iters=8, ctrl="osc", na=7, ne=0):
    """Float operations per scenario of each kernel, counted from the
    kernels' arithmetic stage by stage (multiply and add count one each),
    for `nrows` contact rows of which `nact` are active (the mean over this
    run's scenarios: the solve whitens, multiplies and projects only the
    active rows' columns) and `ne` equality rows (always active, never
    projected), the contact solve's iteration counts and the
    arm's torque law (`ctrl`, "osc" or "joint_pos", over `na` arm dofs),
    split by the type the function needs: the CRBA/RNEA sums, the Cholesky factorisations and
    solves, the whitening and the OSC law in float64, as the kernels and
    the plain versions compute them; the rest in float32, the solve's
    products with the whitened operator included. Returns
    {"K1", "K2", "K3", "K3-aux", "K4": (float32 flops, float64 flops)}."""
    from robosuite_tpu_torch.models import spec as S
    from robosuite_tpu_torch.physics import contact as C

    nb, nv, ng, ns = model.nbody, model.nv, model.ngeom, model.nsite
    anc = model.ancestor_mask.cpu()
    pairs_db = int(anc.sum())                                    # (body, dof) pairs in a subtree
    ntot = 3 * nrows + ne
    fk = nb * (27 + 24 + 27) + nv * (27 + 24 + 30)               # tree walk: rotate, compose, joint
    poses = nb * (30 + 18 + 24 + 30) + (ng + ns) * (18 + 24 + 30)
    crba = pairs_db * (6 + 15 + 6 + 15 + 6 + 6) + nv * nv * 12
    rnea = pairs_db * 24 + nv * 30 + nb * (4 * 30 + 40) + nv * nb * 6 + 30
    k1 = (fk + poses, crba + rnea)
    chol = nv ** 3 // 3 + 2 * nv * nv
    nac = 3 * nact + ne                                          # the active columns
    yx, ytx = 2 * nv * nac, 2 * nv * nac + 2 * nac               # Y x; R x + Y^T (Y x)
    k2_64 = (2 * chol + 2 * nv * nv + nv * ntot + nv * nv       # factorisations and solves, the inactive sum
             + nac * nv * (nv + 4))                              # whitening of the active columns
    k2_32 = ((power_iters + iters + 2) * yx + (power_iters + iters + 1) * ytx  # products with Y
             + 2 * ntot + power_iters * 3 * nac + iters * (20 * nact + 5 * ne))  # norms, the projection
    k2 = (k2_32, k2_64)
    if ctrl == "osc":
        law = (0, 2 * na ** 3 + 3 * 6 * na * na + 6 * 6 * na + 2 * 6 ** 3 + nv * 24)
    else:                                                        # kp e - kd qdot, M_arm times it, + bias, clip
        law = (na * 4 + 2 * na * na + 2 * na, 0)
    groups = {key: len(items) for key, items in C.pair_groups(model).items()}
    n_bb, n_pb = groups.get((S.BOX, S.BOX), 0), groups.get((S.PLANE, S.BOX), 0)
    n_cb = groups.get((S.CYLINDER, S.BOX), 0)
    n_pc, n_cc = groups.get((S.PLANE, S.CYLINDER), 0), groups.get((S.CYLINDER, S.CYLINDER), 0)
    # box-box, plane-box, capsule-box, plane-cylinder, capsule-capsule
    cands = n_bb * (16 * 90 + 9 * 110) + n_pb * 8 * 30 + n_cb * 2 * 90 + n_pc * 3 * 45 + n_cc * 110
    narrow = cands + nrows * 40
    rows = nrows * (nv * (6 + 3 * 6) + 60)
    k3 = (k1[0] - (ng + ns) * 72 + law[0] + narrow + rows + k2[0] + nv * 20, k1[1] + law[1] + k2[1])
    k4 = nb * (27 + 28) + nv * (3 * 27 + 28 + 26)               # pose-only walk: rotate, compose, hinge
    aux = k4 + nb * 30 + ns * (18 + 24 + 30) + model.npair * 2 * 72 + cands  # walk, matrices, sites, pair poses
    return {"K1": k1, "K2": k2, "K3": k3, "K3-aux": (k3[0] + aux, k3[1]), "K4": (k4, 0)}


def bound(bytes_, flops, n):
    """(bound_ms, bound_by) of n scenarios: the larger of bytes over HBM
    bandwidth and the float operations at the peak rate of their type
    (flops = (float32, float64) per scenario)."""
    t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
    t_ops = (flops[0] / PEAK_FP32_FLOP_PER_S + flops[1] / PEAK_FP64_FLOP_PER_S) * n * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# The compiled kernel of each variant (K3 and K3-JP share one instantiation,
# K3-aux and K3-aux-JP the other; the law is chosen by the table; K2 has
# one without equality rows and one with them, K2-eq, each at 2 scenarios
# a block and at 1 (K2-wide, on a world too wide for 2: GR1's nv 60); K1
# at 4 scenarios a block and at 2, K1-wide, on GR1's wide worlds).
VARIANT_KERNEL = {"K1": "rs_forward_kernelILi4E", "K1-wide": "rs_forward_kernelILi2E",
                  "K2": "rs_contact_solve_kernelILb0ELi2E", "K2-eq": "rs_contact_solve_kernelILb1ELi2E",
                  "K2-wide": "rs_contact_solve_kernelILb0ELi1E", "K3": "rs_substep_kernelILb0",
                  "K3-JP": "rs_substep_kernelILb0", "K3-aux": "rs_substep_kernelILb1",
                  "K3-aux-JP": "rs_substep_kernelILb1", "K4": "rs_fk_kernel"}


def ptxas_report(log_path):
    """{variant: {registers, spill_stores, spill_loads, stack_frame}} from
    the kernels' build.log (nvcc -Xptxas -v)."""
    import re

    per_fn, cur = {}, None
    with open(log_path) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                cur = per_fn.setdefault(m.group(1), {})
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and cur is not None:
                cur.update(stack_frame=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
            m = re.search(r"Used (\d+) registers", line)
            if m and cur is not None:
                cur["registers"] = int(m[1])
    return {v: next(r for fn, r in per_fn.items() if k in fn) for v, k in VARIANT_KERNEL.items()}


def kernel_rows(prof):
    """[(kernel, ms, launches)] of the device activities a profiler run
    recorded, each counted once, by device time (straight from the trace's
    events: a few seconds for a million, where key_averages takes
    minutes)."""
    from torch.autograd import DeviceType

    acc = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            r = acc.setdefault(e.name(), [0.0, 0])
            r[0] += e.duration_ns() / 1e6
            r[1] += 1
    return sorted(((k, ms, n) for k, (ms, n) in acc.items()), key=lambda r: -r[1])


def profile_once(tag, label, fn, top, kernels_only=False):
    """fn() once under torch.profiler; prints the wall time, the device's
    busy time, the `top` kernels by device time and the device time of
    every kernel of the port (rs_*). "Device busy" sums key_averages' rows
    with device time (an aten op's row and its kernels' rows both count),
    and beside it the kernels' time counted once (kernel_rows); with
    `kernels_only` the profiler records the device alone and only the
    latter is computed (a window of a million kernels). -> (fn's result,
    wall ms, busy ms, the top rows, the port's rows), each row (kernel,
    ms, launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] if kernels_only else [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = kernel_rows(prof)
    kern_ms = sum(r[1] for r in kern)
    if kernels_only:
        rows, dev_ms = kern, kern_ms
    else:
        rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                       if e.self_device_time_total > 0), key=lambda r: -r[1])
        dev_ms = sum(r[1] for r in rows)
    print(f"{tag} {label} under the profiler: wall {wall_ms:.2f} ms, device busy {dev_ms:.2f} ms "
          f"({100 * dev_ms / wall_ms:.1f}%); the kernels counted once {kern_ms:.2f} ms "
          f"({100 * kern_ms / wall_ms:.1f}%, {sum(r[2] for r in kern)} launches)")
    for key, ms, n in rows[:top]:
        print(f"{tag}   {ms:8.3f} ms  x{n:<5d} {key[:90]}")
    port = [(k.split("(")[0].split()[-1], ms, n) for k, ms, n in rows if "rs_" in k]
    print(f"{tag}   the port's kernels: " + "; ".join(f"{k} {ms:.3f} ms x{n}" for k, ms, n in port))
    return out, wall_ms, dev_ms, rows[:top], port


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


PHASE_T = [time.perf_counter()]


def phase_done(name):
    now = time.perf_counter()
    print(f"phase {name}: {now - PHASE_T[0]:.1f} s", flush=True)
    PHASE_T[0] = now


def release_memory(before):
    """Return to the card what the earlier phases' objects held: their
    reference cycles collected (an env, its robots and its model's cached
    contact-rows graphs, each graph with a private memory pool), then the
    allocator's cached blocks freed; the memory left is printed."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    print(f"device memory before {before}: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
          f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved", flush=True)


@contextlib.contextmanager
def plain_path(env):
    """Route the env's kernel wrappers to their plain versions on the card:
    the forward products (K1) and the fused substep with and without aux
    (K3, K3-aux), as the env fetches them when a hook runs or is made."""
    from robosuite_tpu_torch.ops import forward, substep
    from robosuite_tpu_torch.physics import engine

    saved = engine.forward_products

    def forward_products(model, qpos, qvel):
        return forward.forward_plain(model, qpos, qvel, *forward.runtime_leaves(model, qpos.shape[0]))

    def fused_for(model, emit_aux=False):
        plain = substep.substep_aux_plain if emit_aux else substep.substep_plain
        return lambda *args: plain(env, model, *args)

    engine.forward_products, env._fused_for = forward_products, fused_for
    try:
        yield
    finally:
        engine.forward_products = saved
        del env._fused_for


_CPU64 = {}


def tie_witness(model, qpos, bodies, tie=1e-5, touch=1e-3):
    """Float64 witnesses that the contacts of body bodies[n] (of any body
    in the set bodies[n], of any body where bodies[n] is None) at qpos[n]
    (N, nq) hold a decision float32
    rounding can take either way: some box-box pair of the body's geoms
    within `touch` of contact whose SAT tie margin best_e - max_face is
    within `tie` (the edge candidate emitted or not), or whose manifold
    cut ties (the last kept and the first dropped candidate distances
    within `tie`). Computed on the CPU for all N at once. -> one
    description, or None, per n."""
    import torch

    from robosuite_tpu_torch.models import spec as S
    from robosuite_tpu_torch.physics import contact as C
    from robosuite_tpu_torch.physics import kinematics

    if id(model) not in _CPU64:  # the entry holds the model, so its id is not reused
        _CPU64[id(model)] = (model, model.replace().double().to("cpu"))
    m64 = _CPU64[id(model)][1]
    kin = kinematics.fk(m64, qpos.detach().to("cpu", m64.geom_size.dtype))

    def operand(g):
        return (tuple(kin.geom_xpos[:, g, i] for i in range(3)),
                [[kin.geom_xmat[:, g, i, j] for j in range(3)] for i in range(3)],
                tuple(m64.geom_size[g, i] for i in range(3)))

    npts = C.model_pair_points(model, S.BOX, S.BOX)
    out = [None] * len(bodies)
    for k in range(model.npair):
        g1, g2 = model.pair_geom1[k], model.pair_geom2[k]
        rows = [n for n, body in enumerate(bodies) if out[n] is None and _touches(body, model, k)]
        if not rows or model.geom_type[g1] != S.BOX or model.geom_type[g2] != S.BOX:
            continue
        args = operand(g1) + operand(g2)
        d = torch.sort(torch.stack([c[0] for c in C._np_box_box(*args)], dim=-1), dim=-1).values
        max_face, best_e, _ = C.box_box_sat(*args)
        margin = best_e - max_face
        for n in rows:
            if float(d[n, 0]) > touch:
                continue
            if abs(float(margin[n])) <= tie:
                out[n] = f"pair {k}: SAT tie margin {float(margin[n]):.3e} (deepest {float(d[n, 0]):.6e})"
            elif abs(float(d[n, npts] - d[n, npts - 1])) <= tie and float(d[n, npts - 1]) <= touch:
                out[n] = (f"pair {k}: manifold cut tie, kept {float(d[n, npts - 1]):.6e} "
                          f"dropped {float(d[n, npts]):.6e}")
    return out


def _touches(body, model, k):
    """Whether pair k has a geom of `body` (an index, a set of them, or
    None: any body)."""
    owners = (model.geom_bodyid[model.pair_geom1[k]], model.geom_bodyid[model.pair_geom2[k]])
    if body is None:
        return True
    return bool(set(owners) & body) if isinstance(body, set) else body in owners


def contact_island(model, con, n, body, touch=1e-3):
    """The bodies whose velocities scenario n's contact solve couples with
    `body`'s: the kinematic trees (all bodies below one child of the world)
    that hold dofs, joined wherever a row between two of them lies within
    `touch` of its activation in `con` (the float64 narrowphase); a tree
    without dofs (the table) joins none. Two grippers on one pot make one
    island of both robots and the pot: a tie at any of its rows moves every
    body in it."""
    parent = model.body_parentid

    def root(b):
        while parent[b] != 0:
            b = parent[b]
        return b

    roots = [root(b) for b in range(model.nbody)]
    moving = {roots[b] for b in model.dof_bodyid}
    near = (con["dist"][n] - con["margin"] <= touch).tolist()
    links = {}
    for r, (b1, b2) in enumerate(zip(con["body1"], con["body2"])):
        r1, r2 = roots[b1], roots[b2]
        if near[r] and r1 != r2 and r1 in moving and r2 in moving:
            links.setdefault(r1, set()).add(r2)
            links.setdefault(r2, set()).add(r1)
    seen, todo = {roots[body]}, [roots[body]]
    while todo:
        for x in links.get(todo.pop(), ()):
            if x not in seen:
                seen.add(x)
                todo.append(x)
    return {b for b in range(model.nbody) if roots[b] in seen}


def contact_tie_witness(model, qpos, bodies, tie=1e-5, touch=1e-3):
    """tie_witness, and besides it the discrete choices of the plain
    contact rows that float32 rounding can take either way, recomputed in
    float64 at qpos[n] (N, nq) on the CPU, for the pairs of the bodies of
    body bodies[n]'s contact island (contact_island; of any body where
    None): a selection of the k deepest candidates (a
    hull's deepest vertices, a pair's manifold cut) whose last kept and
    first dropped depths lie within `tie`, the kept one within `touch` of
    contact (a hull resting flat ties its bottom vertices); or a row
    within `tie` of its activation threshold (dist = margin), which moves
    every later row's compacted slot. -> one description, or None, per n."""
    import torch

    from robosuite_tpu_torch.physics import contact as C
    from robosuite_tpu_torch.physics import kinematics

    if id(model) not in _CPU64:  # the entry holds the model, so its id is not reused
        _CPU64[id(model)] = (model, model.replace().double().to("cpu"))
    m64 = _CPU64[id(model)][1]
    kin = kinematics.fk(m64, qpos.detach().to("cpu", m64.geom_size.dtype))
    con = C.narrowphase(m64, kin)
    bodies = [None if b is None else contact_island(model, con, n, b, touch) for n, b in enumerate(bodies)]
    out = tie_witness(model, qpos, bodies, tie, touch)
    select, cuts = C.select_deepest, []

    def recording(d, k):  # d (N, P, n): a (scenario, pair) flag of each near-tie cut
        if d.shape[-1] > k:
            ds = torch.sort(d, dim=-1).values
            cuts.append((ds[..., k] - ds[..., k - 1] <= tie) & (ds[..., k - 1] <= touch))
        return select(d, k)

    C.select_deepest = recording
    try:
        for key, items in sorted(C.pair_groups(m64).items()):
            cuts.clear()
            C.narrowphase(m64, kin, pairs={k for _, _, k, _ in items})
            for flags in cuts:
                flags = flags.reshape(flags.shape[0], len(items), -1).any(dim=-1)
                for n in range(len(out)):
                    for p, (_, _, k, _) in enumerate(items):
                        if out[n] is None and bool(flags[n, p]) and _touches(bodies[n], model, k):
                            out[n] = f"pair {k}: a k-deepest selection within {tie:.0e} of a tie, touching (float64)"
    finally:
        C.select_deepest = select
    near = (con["dist"] - con["margin"]).abs() <= tie
    for k, rows in C.contact_row_layout(m64).items():
        hit = near[:, rows].any(dim=-1)
        for n in range(len(out)):
            if out[n] is None and bool(hit[n]) and _touches(bodies[n], model, k):
                out[n] = f"pair {k}: a row within {tie:.0e} of its activation threshold (float64)"
    return out


def hold_cubes(label, model, bodies, qpos_in, out_k, out_p, tol_q=1e-5, tol_v=1e-3):
    """Hold the free boxes `bodies` after one substep from the same input
    qpos_in (B, nq), kernel out_k vs plain out_p ((qpos, qvel) each), in
    every scenario. A (scenario, box) beyond the tolerances is set aside
    only with tie_witness at qpos_in; every case is printed. -> (the
    largest qpos and qvel errors left, the number set aside); the caller
    checks them."""
    import torch

    (qk, vk), (qp, vp) = out_k, out_p
    errs, bad = [], []
    for body in bodies:
        j = model.body_jntadr[body]
        qa, da = model.jnt_qposadr[j], model.jnt_dofadr[j]
        eq = (qk[:, qa:qa + 7] - qp[:, qa:qa + 7]).abs().amax(dim=1)
        ev = (vk[:, da:da + 6] - vp[:, da:da + 6]).abs().amax(dim=1)
        errs.append((eq, ev))
        bad += [(b, body, len(errs) - 1) for b in torch.nonzero((eq > tol_q) | (ev > tol_v)).flatten().tolist()]
    witnessed = 0
    if len(bad) > 64:
        FAILED.append(f"{label}: {len(bad)} (scenario, cube) cases beyond tolerance")
        print(f"{label}: {len(bad)} (scenario, cube) cases beyond tolerance  <-- FAILED")
    elif bad:
        whys = tie_witness(model, qpos_in[[b for b, _, _ in bad]], [body for _, body, _ in bad])
        for (b, body, i), why in zip(bad, whys):
            eq, ev = errs[i]
            print(f"{label} scenario {b} body {body}: qpos err {float(eq[b]):.3e} qvel err {float(ev[b]):.3e}; "
                  f"{why or 'NO near-tie witness'}")
            if why:
                eq[b] = ev[b] = 0.0
                witnessed += 1
                ASIDE.append(label)
    return (max(float(eq.max()) for eq, _ in errs), max(float(ev.max()) for _, ev in errs), witnessed)


def hold_substep(label, model, bodies, qpos_in, out_k, out_p, tol_q=1e-5, tol_v=1e-3):
    """Check one substep from the same input, kernel vs plain: the robot
    (arm + fingers, the first 9 coordinates) in every scenario, the free
    boxes with hold_cubes. -> the largest error held."""
    nr = 9
    eq, ev = max_err(out_k[0][:, :nr], out_p[0][:, :nr]), max_err(out_k[1][:, :nr], out_p[1][:, :nr])
    check(f"{label} robot qpos", eq, tol_q)
    check(f"{label} robot qvel", ev, tol_v)
    cq, cv, n = hold_cubes(label, model, bodies, qpos_in, out_k, out_p, tol_q, tol_v)
    check(f"{label} cubes qpos, every scenario ({n} witnessed near-ties set aside)", cq, tol_q)
    check(f"{label} cubes qvel, every scenario", cv, tol_v)
    return max(eq, ev, cq, cv)


def tick_launches(cfg, mpc, env, full):
    """Kernel launches of one MPC tick (solve_batch + the executed
    rollout_batch) that the config implies; `full` = a full
    relinearization tick."""
    H, n_plan = cfg.horizon, mpc.plan_substeps
    n_lin = max(1, int(round(1.0 / (env.control_freq * cfg.fd_timestep)))) if cfg.fd_timestep else n_plan
    k = {"K1": 1 + 2, "K2": 0, "K3": env.n_substeps, "K3-aux": H * n_plan, "K4": 0}  # MPPI start + executed step
    if cfg.n_ilqr_iters:
        k["K1"] += H                      # the nominal rollout: one dynamics call per planned step
        k["K3"] += H * n_plan
        k["K4"] += 2                      # its stage costs and terminal cost
        for _ in range(cfg.n_ilqr_iters):
            k["K1"] += H                  # the line search over all alphas, per planned step
            k["K3"] += H * n_plan
            k["K4"] += 2
            if full:                      # the forward-difference sweep: one dynamics call
                k["K1"] += 1
                k["K3"] += n_lin
    return k


# tools/bench_configs.py:24,48-51: the Stack workload (MPPI only, H=128)
STACK_MPC = dict(horizon=128, n_samples=16, noise_sigma=0.4, temperature=0.2, n_knots=8, n_ilqr_iters=0,
                 plan_timestep=0.025)
STACK_B, STACK_TICKS = 32, 3


def stack_slice(tag, results):
    """Phases 12-16, Panda-Stack with the JOINT_POSITION arm. -> the launch
    counts of the env step (reset + STEPS policy steps), of the MPC ticks
    and of the unfused policy step."""
    import torch

    import robosuite_tpu_torch as R
    from robosuite_tpu_torch.mpc import receding
    from robosuite_tpu_torch.ops import contact_solve, forward, substep
    from robosuite_tpu_torch.physics import contact as C
    from robosuite_tpu_torch.physics import engine

    env = R.make("Stack", robots="Panda", controller_configs="JOINT_POSITION", reward_shaping=True)
    model, robot = env.model, env.robots[0]
    cubes = (env.cubeA_body_id, env.cubeB_body_id)
    nrows = sum(len(r) for r in C.contact_row_layout(model).values())
    plan = model.replace(timestep=STACK_MPC["plan_timestep"], solver_iters=10)  # MPCConfig's planning model
    print(f"Stack world: nq={model.nq} nv={model.nv} nbody={model.nbody} ngeom={model.ngeom} "
          f"npair={model.npair} rows={nrows}; action_dim={env.action_dim}; arm controller "
          f"{type(robot.arm_cfg['right']).__name__}")
    flops = op_counts(model, nrows, ctrl="joint_pos")
    stack_k = results.setdefault("stack_kernels", {})
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)

    # ---- 12. K1 at Stack's widths (B=512: env step, MPPI start; 32: the executed MPC step)
    states, obs = env.reset_batch(B, gen)
    if not all(torch.isfinite(v.float()).all() for v in obs.values()) or not bool(obs["placement_valid"].all()):
        fail("Stack reset: non-finite observations or an invalid placement")
    k1_err, k1_rows = 0.0, results.setdefault("k1_widths", [])
    for n in (B, STACK_B):
        q, qd = states.physics.qpos[:n], states.physics.qvel[:n]
        k1_err = max(k1_err, hold_k1(f"Stack K1 (B={n})", model, q, qd))
        k1_rows.append(dict(world="Stack", **time_width(
            tag, "K1 Stack", lambda: forward.forward_products(model, q, qd),
            lambda: forward.forward_plain(model, q, qd, *forward.model_leaves(model, n)), 20, k1_bytes(model, n),
            flops["K1"], n)))
    leaves = forward.runtime_leaves(model, B)
    k1 = k1_rows[-2]
    stack_k["K1"] = dict(max_abs_err=k1_err, ms=k1["ms"], dev_ms=k1["dev_ms"], plain_ms=k1["plain_ms"],
                         bound=(k1["bound_ms"], k1["bound_by"]))

    # a contact-rich state: cubeA dropped onto cubeB in every other scenario
    # (stacked boxes with parallel faces, the structural SAT tie), the other
    # scenarios' cubes on the table; four zero-action steps to land
    qa_A = model.jnt_qposadr[model.body_jntadr[cubes[0]]]
    qa_B = model.jnt_qposadr[model.body_jntadr[cubes[1]]]
    qpos = states.physics.qpos.clone()
    off = torch.zeros(B // 2, 3, device="cuda")
    off[:, :2] = 0.005 * (2 * torch.rand(B // 2, 2, generator=gen, device="cuda") - 1)
    off[:, 2] = 0.025 + 0.02 + 0.002
    qpos[::2, qa_A:qa_A + 3] = qpos[::2, qa_B:qa_B + 3] + off
    s = env.state_from_flattened(torch.cat([states.physics.time[:, None], qpos, states.physics.qvel], 1).cpu())
    zero = torch.zeros(B, env.action_dim, device="cuda")
    for _ in range(4):
        s, _ = env.rollout_batch(s, zero)
    torch.cuda.synchronize()
    stacked = int((s.physics.qpos[:, qa_A + 2] > s.physics.qpos[:, qa_B + 2] + 0.03).sum())
    print(f"Stack contact state: cubeA resting on cubeB in {stacked}/{B} scenarios")
    if stacked < B // 4:
        fail("the Stack contact state has too few stacked scenarios")
    q, qd = s.physics.qpos, s.physics.qvel

    # ---- 13. K2 at Stack's width, on the plain path's operands at that state
    kin, M, bias = forward.forward_plain(model, q, qd, *leaves)
    ctrl = robot.run_controllers(kin, M, bias, q, qd, s.ctrl, torch.zeros(B, model.nu, device="cuda"))
    qfrc, extra = engine.total_smooth_force(model, q, qd, ctrl, M, bias)
    JfT, aref, reg3, mu, act = C.solver_inputs(model, kin, C.narrowphase(model, kin), qd, model.timestep)
    args = (M.contiguous(), JfT, aref.contiguous(), qfrc.contiguous(), qd.contiguous(),
            (model.dof_damping + extra).contiguous(), reg3.contiguous(), mu, act.contiguous())
    n_act = act.sum(1)
    print(f"Stack active contact rows per scenario: min {int(n_act.min())} median {int(n_act.median())} "
          f"max {int(n_act.max())} (of {nrows})")
    if int(n_act.max()) < 8:
        fail("fewer than 8 active contact rows at the Stack contact state")
    nact = float(n_act.float().mean())  # K3-JP and K3-aux-JP run at this state too
    flops = op_counts(model, nrows, nact, ctrl="joint_pos")
    aux_flops = op_counts(plan, nrows, nact, iters=10, ctrl="joint_pos")["K3-aux"]
    solve_args = (C.APGD_ITERS, C.POWER_ITERS, model.timestep)
    qv_k, f_k = contact_solve.vel_update(*args, *solve_args)
    qv_p, f_p = contact_solve.vel_update_plain(*args, *solve_args)
    torch.cuda.synchronize()
    check("Stack K2 qvel", max_err(qv_k, qv_p), 1e-4)
    check("Stack K2 f (relative)", max_err(f_k, f_p) / max(1.0, float(f_p.abs().max())), 1e-4)
    stack_k["K2"] = dict(max_abs_err=max(max_err(qv_k, qv_p), max_err(f_k, f_p)),
                         ms=cuda_ms(lambda: contact_solve.vel_update(*args, *solve_args), 20),
                         plain_ms=cuda_ms(lambda: contact_solve.vel_update_plain(*args, *solve_args), 3),
                         bound=bound(nbytes(*args, qv_k, f_k), flops["K2"], B))

    # ---- 14. K3-JP (B=512, 32) and K3-aux-JP (B*K=512, planning model) at that state,
    # the arm driven by random joint deltas
    a = torch.clamp(0.5 * torch.randn(B, env.action_dim, generator=gen, device="cuda"), -1.0, 1.0)
    ctrl_s = robot.set_goals(kin, M, bias, q, qd, s.ctrl, a)
    goal, gains = env._fused_goal_fn(robot, "right", ctrl_s, kin)
    grip = robot.gripper_ctrl("right", ctrl_s).contiguous()
    k3_args = (q, qd, *leaves, goal, gains, grip)
    fused = env._fused_for(model)
    k3_err = 0.0
    for n in (B, STACK_B):
        sub = tuple(t[:n].contiguous() for t in k3_args)
        out_k, out_p = fused(*sub), substep.substep_plain(env, model, *sub)
        torch.cuda.synchronize()
        k3_err = max(k3_err, hold_substep(f"K3-JP (B={n})", model, cubes, sub[0], out_k[:2], out_p[:2]))
    one = tuple(t[:STACK_B].contiguous() for t in k3_args)
    results["K3-JP_ms_B32"] = cuda_ms(lambda: fused(*one), 20)
    results["resident_per_sm"]["K3-JP"] = substep.resident_per_sm(fused)
    print(f"{tag} K3-JP ms/launch at B={STACK_B} (every scenario on an SM of its own: one scenario's latency): "
          f"{results['K3-JP_ms_B32']:.4f}; resident scenarios per SM (Stack): {results['resident_per_sm']['K3-JP']}")
    out_k = fused(*k3_args)
    results["kernels"]["K3-JP"] = dict(
        max_abs_err=k3_err, ms=cuda_ms(lambda: fused(*k3_args), 20),
        plain_ms=cuda_ms(lambda: substep.substep_plain(env, model, *k3_args), 3),
        bound=bound(nbytes(*k3_args, *out_k), flops["K3"], B))

    fused_aux = env._fused_for(plan, emit_aux=True)
    kin_plan = forward.forward_plain(plan, q, qd, *leaves)[0]
    goal_a, gains_a = env._fused_goal_fn(robot, "right", ctrl_s, kin_plan)
    a_args = (q, qd, *leaves, goal_a, gains_a, grip)
    out_k = fused_aux(*a_args)
    out_p = substep.substep_aux_plain(env, plan, *a_args)
    torch.cuda.synchronize()
    aux_err = hold_substep(f"K3-aux-JP (B={B})", plan, cubes, q, out_k[:2], out_p[:2])
    # the aux tail against its plain version at the kernel's own post-step qpos
    kin2 = forward.forward_plain(plan, out_k[0], out_k[1], *leaves)[0]
    for name, got, want in (("site_xpos", out_k[3], kin2.site_xpos), ("site_xmat", out_k[4], kin2.site_xmat),
                            ("xpos", out_k[5], kin2.xpos)):
        check(f"K3-aux-JP (B={B}) {name}", max_err(got, want), 2e-5)
        aux_err = max(aux_err, max_err(got, want))
    pd_p = C.pair_min_dists(plan, kin2)
    spread(f"K3-aux-JP (B={B}) pair_dist", out_k[6], pd_p)
    aux_err = max(aux_err, hold_pair_dist(f"K3-aux-JP (B={B})", plan, out_k[6], pd_p, out_k[0], out_k[0]))
    results["resident_per_sm"]["K3-aux-JP"] = substep.resident_per_sm(fused_aux)
    print(f"K3-aux-JP resident scenarios per SM (Stack planning model): {results['resident_per_sm']['K3-aux-JP']}")
    results["kernels"]["K3-aux-JP"] = dict(
        max_abs_err=aux_err, ms=cuda_ms(lambda: fused_aux(*a_args), 10),
        plain_ms=cuda_ms(lambda: substep.substep_aux_plain(env, plan, *a_args), 3),
        bound=bound(nbytes(*a_args, *out_k), aux_flops, B))
    phase_done("Stack K1, K2, K3-JP, K3-aux-JP vs plain")
    tangent_checks(tag, "Stack", env, plan, s, 64, results)

    # ---- 15. the Stack env-step slice: reset + 10 policy steps on the fused path
    actions = torch.clamp(0.3 * torch.randn(B, env.action_dim, generator=gen, device="cuda"), -1.0, 1.0)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states, _ = env.reset_batch(B, gen)
    trail, rewards = [states], []
    for _ in range(STEPS):
        states, r = env.rollout_batch(states, actions)
        trail.append(states)
        rewards.append(r)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kcounts()
    take_widths("Stack")
    print(f"Stack main path launches over reset + {STEPS} policy steps: {counts}")
    if counts != {"K1": 2 * STEPS + 1, "K2": 0, "K3": 25 * STEPS, "K3-aux": 0, "K4": 0}:
        fail(f"unexpected Stack launch counts {counts}")
    rew = torch.stack(rewards)
    if not (torch.isfinite(states.physics.qpos).all() and torch.isfinite(states.physics.qvel).all()
            and torch.isfinite(rew).all()):
        fail("non-finite states or rewards on the Stack path")
    print(f"{tag} Stack env policy-steps/s (B={B}, reset + {STEPS} steps, host clock): {B * STEPS / dt:.1f}")
    results.update(stack_policy_steps_per_s=B * STEPS / dt, stack_launches=counts)

    # each policy step of that run, substep by substep: the kernel and the
    # plain substep from the same input, then on from the kernel's output;
    # the last substep's output is the rollout's next state, bit for bit
    worst, worst_r = 0.0, 0.0
    for i in range(STEPS):
        st = trail[i]
        kin, M, bias = engine.forward_products(model, st.physics.qpos, st.physics.qvel)
        ctrl_i = robot.set_goals(kin, M, bias, st.physics.qpos, st.physics.qvel, st.ctrl, actions)
        goal, gains = env._fused_goal_fn(robot, "right", ctrl_i, kin)
        grip = robot.gripper_ctrl("right", ctrl_i).contiguous()
        qp, qv = st.physics.qpos, st.physics.qvel
        for j in range(env.n_substeps):
            sub = (qp, qv, *leaves, goal, gains, grip)
            out_k, out_p = fused(*sub), substep.substep_plain(env, model, *sub)
            (eq, ev), (cq, cv, _) = ((max_err(out_k[0][:, :9], out_p[0][:, :9]), max_err(out_k[1][:, :9], out_p[1][:, :9])),
                                     hold_cubes(f"Stack step {i + 1} substep {j + 1}", model, cubes, qp,
                                                out_k[:2], out_p[:2]))
            worst = max(worst, eq / 1e-5, ev / 1e-3, cq / 1e-5, cv / 1e-3)
            qp, qv = out_k[0], out_k[1]
        nxt = trail[i + 1]
        if not (torch.equal(qp, nxt.physics.qpos) and torch.equal(qv, nxt.physics.qvel)):
            fail(f"Stack policy step {i + 1}: rollout_batch differs from its substep-by-substep kernel run")
        kin_p = forward.forward_plain(model, qp, qv, *leaves)[0]
        worst_r = max(worst_r, max_err(rewards[i], env.reward(nxt.physics, kin_p)))
    torch.cuda.synchronize()
    check(f"Stack {STEPS} policy steps x {env.n_substeps} substeps, kernel vs plain from the same input: the "
          f"largest error over its tolerance (robot every scenario; cubes every scenario but witnessed near-ties)",
          worst, 1.0)
    check(f"Stack {STEPS} policy steps: reward (K1 vs plain poses of the same state)", worst_r, 1e-4)

    # one step with the fused path disabled: K1 every substep + K2 at nv 21 / ntot 288
    start, after = trail[STEPS // 2], trail[STEPS // 2 + 1]
    env._disable_fused = True
    zero_counts()
    s_u, _ = env.rollout_batch(start, actions)
    torch.cuda.synchronize()
    counts_u = kcounts()
    take_widths("Stack")
    print(f"Stack unfused policy step launches: {counts_u}")
    if counts_u != {"K1": env.n_substeps + 2, "K2": env.n_substeps, "K3": 0, "K3-aux": 0, "K4": 0}:
        fail(f"unexpected Stack unfused launch counts {counts_u}")
    check("Stack unfused vs fused policy step robot qpos", max_err(s_u.physics.qpos[:, :9], after.physics.qpos[:, :9]), 1e-4)
    check("Stack unfused vs fused policy step robot qvel", max_err(s_u.physics.qvel[:, :9], after.physics.qvel[:, :9]), 1e-3)
    # the same step substep by substep, unfused vs fused from the same input
    kin, M, bias = engine.forward_products(model, start.physics.qpos, start.physics.qvel)
    ctrl_u = robot.set_goals(kin, M, bias, start.physics.qpos, start.physics.qvel, start.ctrl, actions)
    sub_u = env._substep_fn(model, ctrl_u, kin)
    env._disable_fused = False
    sub_f = env._substep_fn(model, ctrl_u, kin)
    ph, worst = start.physics, 0.0
    for j in range(env.n_substeps):
        (pf, _), (pu, _) = sub_f(ph), sub_u(ph)
        eq, ev = max_err(pf.qpos[:, :9], pu.qpos[:, :9]), max_err(pf.qvel[:, :9], pu.qvel[:, :9])
        cq, cv, _ = hold_cubes(f"Stack unfused vs fused substep {j + 1}", model, cubes, ph.qpos,
                               (pf.qpos, pf.qvel), (pu.qpos, pu.qvel))
        worst = max(worst, eq / 1e-5, ev / 1e-3, cq / 1e-5, cv / 1e-3)
        ph = pf
    torch.cuda.synchronize()
    check(f"Stack unfused vs fused, {env.n_substeps} substeps from the same input: the largest error over its "
          f"tolerance (robot every scenario; cubes every scenario but witnessed near-ties)", worst, 1.0)
    phase_done("Stack env-step slice (reset + policy steps, profile, kernel vs plain, unfused)")

    # ---- 16. the Stack MPC at tools/bench_configs.py's width: B=32, H=128, K=16, MPPI only
    cfg = receding.MPCConfig(**STACK_MPC)
    mpc = receding.RecedingMPC(env, cfg)
    solve = mpc.make_solve_batch()
    gm = torch.Generator(device="cuda").manual_seed(SEED + 21)
    mstates, _ = env.reset_batch(STACK_B, gm)
    ms = mpc.init_state(STACK_B, torch.Generator(device="cuda").manual_seed(SEED + 22))

    def tick(states_, ms_):
        acts, ms2, met = solve(states_, ms_)
        states2, rewards_ = env.rollout_batch(states_, acts)
        return states2, ms2, met, acts, rewards_

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mstates, ms, met, acts, rew = tick(mstates, ms)
    torch.cuda.synchronize()
    print(f"{tag} Stack MPC warm-up tick s: {time.perf_counter() - t0:.3f}")
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = tick_launches(cfg, mpc, env, False)
    for i in range(STACK_TICKS):
        before = kcounts()
        mstates, ms, met, acts, rew = tick(mstates, ms)
        after = kcounts()
        got = {k: after[k] - before[k] for k in after}
        print(f"Stack MPC tick {i + 1} launches: {got}")
        if got != want:
            fail(f"Stack MPC tick {i + 1}: launches {got}, the config implies {want}")
        if not (torch.isfinite(acts).all() and acts.abs().max() <= 1.0 and torch.isfinite(rew).all()):
            fail(f"Stack MPC tick {i + 1}: non-finite or out-of-range actions, or non-finite rewards")
    torch.cuda.synchronize()
    mpc_dt = time.perf_counter() - t0
    mpc_counts = kcounts()
    take_widths("Stack")
    solves = STACK_B * STACK_TICKS / mpc_dt
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"{tag} Stack MPC solves/s (B={STACK_B}, H={cfg.horizon}, K={cfg.n_samples}, MPPI only; ticks "
          f"1-{STACK_TICKS}, host clock): {solves:.1f}; mean executed reward {float(rew.mean()):.4f}; "
          f"masked rollouts {int(met['n_masked'].sum())}; peak device memory {peak_gb:.2f} GB")
    results.update(stack_mpc_solves_per_s=solves, stack_mpc_launches=mpc_counts, stack_mpc_peak_gb=peak_gb)
    for k, r in stack_k.items():
        print(f"{tag} Stack {k}: {r['ms']:.4f} ms/launch at B={B}, plain {r['plain_ms']:.3f} ms, "
              f"bound {r['bound'][0]:.5f} ms ({r['bound'][1]})")
    phase_done("Stack MPC at full width")
    return counts, mpc_counts, counts_u


def lift_step_batch(tag, env, gen, results):
    """Phase 17: Lift's step_batch (the RL entry point: observations
    through the pipeline, reward, done) at B=512 for 3 policy steps, its
    launches counted from zero over the reset and those steps alone; then
    each step held against a rollout_batch step from the same input: the
    same states bit for bit (the same kernels on the same inputs), finite
    observations and rewards, done False, the reset's observation keys
    (but placement_valid, which only the reset reports). -> its launch
    counts."""
    import torch

    actions = torch.clamp(0.3 * torch.randn(B, env.action_dim, generator=gen, device="cuda"), -1.0, 1.0)
    zero_counts()
    states, obs0 = env.reset_batch(B, gen)
    steps = []
    for _ in range(3):
        nxt, obs, r, done, _ = env.step_batch(states, actions)
        steps.append((states, nxt, obs, r, done))
        states = nxt
    torch.cuda.synchronize()
    counts = kcounts()
    take_widths("Lift")
    print(f"Lift step_batch launches over the reset and 3 policy steps: {counts}")
    want = {"K1": 1 + 2 * 3, "K2": 0, "K3": 25 * 3, "K3-aux": 0, "K4": 0}
    if counts != want:
        fail(f"Lift step_batch launches {counts}, expected {want}")
    for i, (states, nxt, obs, r, done) in enumerate(steps):
        ref, r_ref = env.rollout_batch(states, actions)
        torch.cuda.synchronize()
        if not (torch.equal(nxt.physics.qpos, ref.physics.qpos) and torch.equal(nxt.physics.qvel, ref.physics.qvel)
                and torch.equal(r, r_ref)):
            fail(f"Lift step_batch step {i + 1}: the state or reward differs from rollout_batch's")
        if set(obs) != set(obs0) - {"placement_valid"}:
            fail(f"Lift step_batch step {i + 1}: observation keys {sorted(set(obs) ^ set(obs0))} differ from the reset's")
        if not (all(torch.isfinite(v).all() for v in obs.values()) and torch.isfinite(r).all()) or bool(done.any()):
            fail(f"Lift step_batch step {i + 1}: non-finite observations or rewards, or done before the horizon")
    print(f"Lift step_batch: 3 policy steps equal to rollout_batch's; obs keys {len(obs)}, robot0_proprio-state "
          f"{tuple(obs['robot0_proprio-state'].shape)}")
    results["lift_step_batch_launches"] = counts
    phase_done("Lift step_batch")
    return counts


S_NAMES = {0: "plane", 2: "sphere", 3: "capsule", 5: "cylinder", 6: "box", 7: "hull"}  # geom types (models/spec.py)

# tools/bench_configs.py:24-27,44-51: the Door workload (MPPI only, H=64)
DOOR_MPC = dict(horizon=64, n_samples=16, noise_sigma=0.4, temperature=0.2, n_knots=8, n_ilqr_iters=0,
                plan_timestep=0.025)
DOOR_B, DOOR_TICKS = 32, 3


def hold_all(label, model, qpos_in, out_k, out_p, tol_q=1e-5, tol_v=1e-3, tol_f=1e-4, quiet=False, extra=None):
    """One substep from the same input qpos_in, kernel out_k vs plain out_p
    ((qpos, qvel) or (qpos, qvel, f)): every coordinate of every scenario
    and the solver forces relative to their largest. A scenario beyond a
    tolerance is set aside only with contact_tie_witness at qpos_in, at
    the pairs of the contact island of the body whose velocity differs
    most (the bodies one contact solve couples with it): a row decision
    (a box-box SAT or manifold cut tie, a k-deepest selection, a row at
    its activation threshold) that the float32 rounding of the two
    versions' poses takes either way (Door's finger pads and handle parts
    lie flush, turning about one axis; an upright can's bottom ring ties;
    a gripper whose pads closed on each other beside the pot it and the
    other gripper hold moves the pot). More than max(64, half the batch)
    scenarios past a tolerance fail at once, unwitnessed (half the batch:
    TwoArmTransport's scenarios share its objects' fixed poses, so one tie
    of the payload's head in the bin's wall meets a quarter of them in the
    same substep). `extra` (the unfused substeps':
    pose_rounding_witness) gives a further float64 witness, for the
    scenarios that one leaves: a callable, their indices -> a description
    or None each. Every case is printed, and every check unless `quiet`
    (then only the failed ones). -> the largest error held."""
    import torch

    errs = {"qpos": ((out_k[0] - out_p[0]).abs().amax(dim=1), tol_q),
            "qvel": ((out_k[1] - out_p[1]).abs().amax(dim=1), tol_v)}
    if len(out_k) > 2:
        scale = max(1.0, float(out_p[2].abs().max()))
        errs["f (relative)"] = ((out_k[2] - out_p[2]).abs().amax(dim=1) / scale, tol_f)
    over = torch.zeros_like(errs["qpos"][0], dtype=torch.bool)
    for e, tol in errs.values():
        over |= e > tol
    bad = torch.nonzero(over).flatten().tolist()
    witnessed = 0
    if len(bad) > max(64, over.shape[0] // 2):
        FAILED.append(f"{label}: {len(bad)} scenarios beyond tolerance")
        print(f"{label}: {len(bad)} scenarios beyond tolerance  <-- FAILED")
    elif bad:
        worst = (out_k[1] - out_p[1]).abs().argmax(dim=1).tolist()
        bodies = [model.dof_bodyid[worst[b]] for b in bad]
        whys = contact_tie_witness(model, qpos_in[bad], bodies)
        left = [b for b, why in zip(bad, whys) if why is None]
        if extra is not None and left:
            more = dict(zip(left, extra(left)))
            whys = [why or more[b] for b, why in zip(bad, whys)]
        for b, why in zip(bad, whys):
            print(f"{label} scenario {b}: " + ", ".join(f"{n} err {float(e[b]):.3e}" for n, (e, _) in errs.items())
                  + f"; {why or 'NO near-tie witness'}")
            if why:
                for e, _ in errs.values():
                    e[b] = 0.0
                witnessed += 1
                ASIDE.append(label)
    for n, (e, tol) in errs.items():
        if not (quiet and float(e.max()) <= tol):
            check(f"{label} {n}, every scenario ({witnessed} witnessed near-ties set aside)", float(e.max()), tol)
    return max(float(errs["qpos"][0].max()), float(errs["qvel"][0].max()))


def door_slice(tag, results):
    """Phases 18-22, Door-Panda with OSC_POSE. -> the launch counts of the
    env step (reset + STEPS step_batch policy steps), of the unfused policy
    step and of the MPC ticks."""
    import torch

    import robosuite_tpu_torch as R
    from robosuite_tpu_torch import ab_kernels
    from robosuite_tpu_torch.mpc import receding
    from robosuite_tpu_torch.ops import contact_solve, forward, substep
    from robosuite_tpu_torch.physics import contact as C
    from robosuite_tpu_torch.physics import engine

    # ---- 18. the Door world, K1 at its widths and a contact-rich state
    env = R.make("Door", robots="Panda", reward_shaping=True, seed=SEED)
    model, robot = env.model, env.robots[0]
    nrows = sum(len(r) for r in C.contact_row_layout(model).values())
    plan = model.replace(timestep=DOOR_MPC["plan_timestep"], solver_iters=10)  # MPCConfig's planning model
    groups = {f"{S_NAMES[a]}-{S_NAMES[b]}": len(v) for (a, b), v in sorted(C.pair_groups(model).items())}
    print(f"Door world: nq={model.nq} nv={model.nv} nbody={model.nbody} ngeom={model.ngeom} nsite={model.nsite} "
          f"npair={model.npair} rows={nrows}; pairs by type {groups}")
    if (model.nq, model.npair, nrows) != (11, 60, 170):
        fail("the Door world is not nq 11, 60 pairs, 170 rows")
    door_k = results.setdefault("door_kernels", {})
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    states, obs = env.reset_batch(B, gen)
    if not all(torch.isfinite(v.float()).all() for v in obs.values()):
        fail("Door reset: non-finite observations")
    flops = op_counts(model, nrows)
    k1_err, k1_rows = 0.0, results.setdefault("k1_widths", [])
    for n in (B, DOOR_B):
        q, qd = states.physics.qpos[:n], states.physics.qvel[:n]
        k1_err = max(k1_err, hold_k1(f"Door K1 (B={n})", model, q, qd))
        k1_rows.append(dict(world="Door", **time_width(
            tag, "K1 Door", lambda: forward.forward_products(model, q, qd),
            lambda: forward.forward_plain(model, q, qd, *forward.model_leaves(model, n)), 20, k1_bytes(model, n),
            flops["K1"], n)))
    k1 = k1_rows[-2]
    door_k["K1"] = dict(max_abs_err=k1_err, ms=k1["ms"], dev_ms=k1["dev_ms"], plain_ms=k1["plain_ms"],
                        bound=(k1["bound_ms"], k1["bound_by"]))
    # the gripper driven by OSC deltas onto the handle (open, then closing),
    # then the hinge and the latch past their limits in some scenarios
    s = ab_kernels.door_contact_state(env, states)
    hq, lq = env.hinge_qpos_addr, env.handle_qpos_addr
    q, qd = s.physics.qpos, s.physics.qvel
    if not (torch.isfinite(q).all() and torch.isfinite(qd).all()):
        fail("the Door contact state is not finite")
    phase_done("Door world, K1, contact state")

    # ---- 19. K2 at Door's width (nv 11, 170 rows), on the plain path's operands
    leaves = forward.runtime_leaves(model, B)
    kin, M, bias = forward.forward_plain(model, q, qd, *leaves)
    ctrl = robot.run_controllers(kin, M, bias, q, qd, s.ctrl, torch.zeros(B, model.nu, device="cuda"))
    qfrc, extra = engine.total_smooth_force(model, q, qd, ctrl, M, bias)
    JfT, aref, reg3, mu, act = C.solver_inputs(model, kin, C.narrowphase(model, kin), qd, model.timestep)
    args = (M.contiguous(), JfT, aref.contiguous(), qfrc.contiguous(), qd.contiguous(),
            (model.dof_damping + extra).contiguous(), reg3.contiguous(), mu, act.contiguous())
    n_act = act.sum(1)
    handle_rows = [r for k in env._contact_pairs(sum(env.robot_models[0].grippers["right"].important_geoms.values(),
                                                     []), env.door.contact_geoms)
                   for r in C.contact_row_layout(model)[k]]
    print(f"Door active contact rows per scenario: min {int(n_act.min())} median {int(n_act.median())} max "
          f"{int(n_act.max())} (of {nrows}); scenarios with a gripper-door contact "
          f"{int((act[:, handle_rows].sum(1) > 0).sum())}/{B}; hinge qpos from {float(q[:, hq].min()):.4f} to "
          f"{float(q[:, hq].max()):.4f} (limits 0, 0.4), the latch past 1.5 in {int((q[:, lq].abs() > 1.5).sum())}")
    # Door's rows past 96 are box-box rows (those of the finger pads on the
    # handle among them), above the maxima before this world: the state must
    # reach them and be rich in contacts
    rows_at = torch.arange(nrows, device="cuda")
    top = torch.where(act > 0, rows_at, -1).max(1).values
    rich, high = int((n_act >= 4).sum()), int((top >= 96).sum())
    print(f"Door contact state: highest active row {int(top.max())}; scenarios with an active row at index >= 96 "
          f"{high}/{B}, with >= 4 active rows {rich}/{B}")
    if 2 * rich < B or 2 * high < B:
        fail(f"the Door contact state is too poor: {rich}/{B} scenarios with >= 4 active rows and {high}/{B} with "
             f"an active row at index >= 96; each must be at least half")
    nact = float(n_act.float().mean())
    flops = op_counts(model, nrows, nact)
    aux_flops = op_counts(plan, nrows, nact, iters=10)["K3-aux"]
    solve_args = (C.APGD_ITERS, C.POWER_ITERS, model.timestep)
    qv_k, f_k = contact_solve.vel_update(*args, *solve_args)
    qv_p, f_p = contact_solve.vel_update_plain(*args, *solve_args)
    torch.cuda.synchronize()
    check("Door K2 qvel", max_err(qv_k, qv_p), 1e-4)
    check("Door K2 f (relative)", max_err(f_k, f_p) / max(1.0, float(f_p.abs().max())), 1e-4)
    door_k["K2"] = dict(max_abs_err=max(max_err(qv_k, qv_p), max_err(f_k, f_p)),
                        ms=cuda_ms(lambda: contact_solve.vel_update(*args, *solve_args), 20),
                        plain_ms=cuda_ms(lambda: contact_solve.vel_update_plain(*args, *solve_args), 3),
                        bound=bound(nbytes(*args, qv_k, f_k), flops["K2"], B))
    phase_done("Door K2 vs plain")

    # ---- 20. K3 (B=512) and K3-aux (B*K=512, planning model) at that state, the
    # arm driven by random deltas
    a = torch.clamp(0.5 * torch.randn(B, env.action_dim, generator=gen, device="cuda"), -1.0, 1.0)
    ctrl_s = robot.set_goals(kin, M, bias, q, qd, s.ctrl, a)
    goal, gains = env._fused_goal_fn(robot, "right", ctrl_s, kin)
    grip = robot.gripper_ctrl("right", ctrl_s).contiguous()
    k3_args = (q, qd, *leaves, goal, gains, grip)
    fused = env._fused_for(model)
    if fused is None:
        fail("the fused substep does not cover the Door world")
    out_k, out_p = fused(*k3_args), substep.substep_plain(env, model, *k3_args)
    torch.cuda.synchronize()
    k3_err = hold_all(f"Door K3 (B={B})", model, q, out_k, out_p)
    results["resident_per_sm"]["K3 Door"] = substep.resident_per_sm(fused)
    results["smem_bytes"] = {"K3 Door": substep.smem_bytes(fused)}
    door_k["K3"] = dict(max_abs_err=k3_err, ms=cuda_ms(lambda: fused(*k3_args), 20),
                        plain_ms=cuda_ms(lambda: substep.substep_plain(env, model, *k3_args), 3),
                        bound=bound(nbytes(*k3_args, *out_k), flops["K3"], B))
    fused_aux = env._fused_for(plan, emit_aux=True)
    kin_plan = forward.forward_plain(plan, q, qd, *leaves)[0]
    goal_a, gains_a = env._fused_goal_fn(robot, "right", ctrl_s, kin_plan)
    a_args = (q, qd, *leaves, goal_a, gains_a, grip)
    out_k = fused_aux(*a_args)
    out_p = substep.substep_aux_plain(env, plan, *a_args)
    torch.cuda.synchronize()
    aux_err = hold_all(f"Door K3-aux (B={B})", plan, q, out_k[:2], out_p[:2])
    # the aux tail against its plain version at the kernel's own post-step qpos
    kin2 = forward.forward_plain(plan, out_k[0], out_k[1], *leaves)[0]
    for name, got, want in (("site_xpos", out_k[3], kin2.site_xpos), ("site_xmat", out_k[4], kin2.site_xmat),
                            ("xpos", out_k[5], kin2.xpos)):
        check(f"Door K3-aux (B={B}) {name}", max_err(got, want), 2e-5)
        aux_err = max(aux_err, max_err(got, want))
    pd_p = C.pair_min_dists(plan, kin2)
    spread(f"Door K3-aux (B={B}) pair_dist", out_k[6], pd_p)
    print(f"Door K3-aux: pairs touching after the step {int((pd_p < 0).sum())} over {B} scenarios; "
          f"pair distances held for all {model.npair} pairs of every scenario")
    aux_err = max(aux_err, hold_pair_dist(f"Door K3-aux (B={B})", plan, out_k[6], pd_p, out_k[0], out_k[0]))
    results["resident_per_sm"]["K3-aux Door"] = substep.resident_per_sm(fused_aux)
    results["smem_bytes"]["K3-aux Door"] = substep.smem_bytes(fused_aux)
    print(f"Door K3 / K3-aux shared memory per scenario {results['smem_bytes']} B; resident scenarios per SM "
          f"{results['resident_per_sm']['K3 Door']} / {results['resident_per_sm']['K3-aux Door']}")
    door_k["K3-aux"] = dict(max_abs_err=aux_err, ms=cuda_ms(lambda: fused_aux(*a_args), 10),
                            plain_ms=cuda_ms(lambda: substep.substep_aux_plain(env, plan, *a_args), 3),
                            bound=bound(nbytes(*a_args, *out_k), aux_flops, B))
    phase_done("Door K3, K3-aux vs plain")

    # ---- 21. the Door step slice: reset_batch + 10 step_batch policy steps
    actions = torch.clamp(0.3 * torch.randn(B, env.action_dim, generator=gen, device="cuda"), -1.0, 1.0)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states, obs0 = env.reset_batch(B, gen)
    trail, rewards, dones, obs_all = [states], [], [], []
    for _ in range(STEPS):
        states, obs, r, done, _ = env.step_batch(states, actions)
        trail.append(states)
        rewards.append(r)
        dones.append(done)
        obs_all.append(obs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kcounts()
    take_widths("Door")
    print(f"Door main path launches over reset + {STEPS} step_batch policy steps: {counts}")
    if counts != {"K1": 2 * STEPS + 1, "K2": 0, "K3": 25 * STEPS, "K3-aux": 0, "K4": 0}:
        fail(f"unexpected Door launch counts {counts}")
    rew = torch.stack(rewards)
    if not (all(torch.isfinite(v).all() for o in obs_all for v in o.values()) and torch.isfinite(rew).all()):
        fail("non-finite observations or rewards on the Door path")
    if any(bool(d.any()) for d in dones) or set(obs_all[-1]) != set(obs0) - {"placement_valid"}:
        fail("Door step_batch: done before the horizon, or observation keys other than the reset's")
    f_eef = obs_all[-1]["robot0_eef_force"].norm(dim=-1)
    print(f"{tag} Door env policy-steps/s (B={B}, reset + {STEPS} step_batch steps, host clock): {B * STEPS / dt:.1f}; "
          f"rewards mean {float(rew.mean()):.4f} max {float(rew.max()):.4f}; |eef force| after the last step: "
          f"max {float(f_eef.max()):.3f} N, nonzero in {int((f_eef > 0).sum())}/{B}")
    results.update(door_policy_steps_per_s=B * STEPS / dt, door_launches=counts)
    # each policy step against the plain path from the same input: plain
    # forward products and 25 plain substeps; the reward on the plain poses
    worst_r = 0.0
    for i in range(STEPS):
        st, nxt = trail[i], trail[i + 1]
        kin, M, bias = forward.forward_plain(model, st.physics.qpos, st.physics.qvel, *leaves)
        ctrl_i = robot.set_goals(kin, M, bias, st.physics.qpos, st.physics.qvel, st.ctrl, actions)
        goal, gains = env._fused_goal_fn(robot, "right", ctrl_i, kin)
        grip = robot.gripper_ctrl("right", ctrl_i).contiguous()
        qp, qv = st.physics.qpos, st.physics.qvel
        for _ in range(env.n_substeps):
            qp, qv, _ = substep.substep_plain(env, model, qp, qv, *leaves, goal, gains, grip)
        hold_step(f"Door policy step {i + 1} (kernel vs plain)", nxt, qp, qv)
        kin_p = forward.forward_plain(model, qp, qv, *leaves)[0]
        worst_r = max(worst_r, max_err(rewards[i], env.reward(engine.State(qpos=qp, qvel=qv, time=nxt.physics.time),
                                                              kin_p)))
    torch.cuda.synchronize()
    check(f"Door {STEPS} policy steps: reward (kernel path vs plain path)", worst_r, 1e-4)
    # one step with the fused path disabled: K1 every substep + K2 at nv 11 / 170 rows
    start, after = trail[STEPS // 2], trail[STEPS // 2 + 1]
    env._disable_fused = True
    zero_counts()
    s_u, _, _, _, _ = env.step_batch(start, actions)
    torch.cuda.synchronize()
    env._disable_fused = False
    counts_u = kcounts()
    take_widths("Door")
    print(f"Door unfused policy step launches: {counts_u}")
    if counts_u != {"K1": env.n_substeps + 2, "K2": env.n_substeps, "K3": 0, "K3-aux": 0, "K4": 0}:
        fail(f"unexpected Door unfused launch counts {counts_u}")
    hold_step("Door unfused vs fused policy step", s_u, after.physics.qpos, after.physics.qvel)
    phase_done("Door step slice (reset + step_batch steps, profile, kernel vs plain, unfused)")

    # ---- 22. the Door MPC at tools/bench_configs.py's width: B=32, H=64, K=16, MPPI only
    cfg = receding.MPCConfig(**DOOR_MPC)
    mpc = receding.RecedingMPC(env, cfg)
    solve = mpc.make_solve_batch()
    gm = torch.Generator(device="cuda").manual_seed(SEED + 31)
    mstates, _ = env.reset_batch(DOOR_B, gm)
    ms = mpc.init_state(DOOR_B, torch.Generator(device="cuda").manual_seed(SEED + 32))

    def tick(states_, ms_):
        acts, ms2, met = solve(states_, ms_)
        states2, rewards_ = env.rollout_batch(states_, acts)
        return states2, ms2, met, acts, rewards_

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mstates, ms, met, acts, rew = tick(mstates, ms)
    torch.cuda.synchronize()
    print(f"{tag} Door MPC warm-up tick s: {time.perf_counter() - t0:.3f}")
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = tick_launches(cfg, mpc, env, False)
    for i in range(DOOR_TICKS):
        before = kcounts()
        mstates, ms, met, acts, rew = tick(mstates, ms)
        after = kcounts()
        got = {k: after[k] - before[k] for k in after}
        print(f"Door MPC tick {i + 1} launches: {got}")
        if got != want:
            fail(f"Door MPC tick {i + 1}: launches {got}, the config implies {want}")
        if not (torch.isfinite(acts).all() and acts.abs().max() <= 1.0 and torch.isfinite(rew).all()):
            fail(f"Door MPC tick {i + 1}: non-finite or out-of-range actions, or non-finite rewards")
    torch.cuda.synchronize()
    mpc_dt = time.perf_counter() - t0
    mpc_counts = kcounts()
    take_widths("Door")
    solves = DOOR_B * DOOR_TICKS / mpc_dt
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"{tag} Door MPC solves/s (B={DOOR_B}, H={cfg.horizon}, K={cfg.n_samples}, MPPI only; ticks "
          f"1-{DOOR_TICKS}, host clock): {solves:.1f}; mean executed reward {float(rew.mean()):.4f}; "
          f"peak device memory {peak_gb:.2f} GB")
    results.update(door_mpc_solves_per_s=solves, door_mpc_launches=mpc_counts, door_mpc_peak_gb=peak_gb)
    for k, r in door_k.items():
        print(f"{tag} Door {k}: {r['ms']:.4f} ms/launch at B={B}, plain {r['plain_ms']:.3f} ms, "
              f"bound {r['bound'][0]:.5f} ms ({r['bound'][1]})")
    phase_done("Door MPC at full width")
    return counts, counts_u, mpc_counts


# tools/bench_configs.py:25,44-51: the PickPlaceCan workload (MPPI only, H=128; unfused)
PICK_MPC = dict(horizon=128, n_samples=16, noise_sigma=0.4, temperature=0.2, n_knots=8, n_ilqr_iters=0,
                plan_timestep=0.025)
PICK_B, PICK_TICKS = 32, 1  # one timed tick (3 before the NutAssembly and Wipe phases)


def hold_rows_graph(label, model, states, dt):
    """The contact rows as the unfused path builds them on the card
    (C.contact_rows: a CUDA graph of the narrowphase and solver_inputs,
    with the equality rows where the world has any, captured once per
    model, batch and dt, replayed on copies of its inputs) against the
    eager code on the same kin, qvel and qpos, all five operands bit for
    bit, at each (kin, qvel, qpos) of `states` in turn."""
    import torch

    from robosuite_tpu_torch.physics import contact as C
    from robosuite_tpu_torch.physics.equality import equality_rows

    names = ("JfT", "aref", "reg3", "mu", "active")
    for i, (kin, qd, q) in enumerate(states):
        got = C.contact_rows(model, kin, qd, dt, q)
        eq = equality_rows(model, kin, q, qd) if model.neq else None
        want = C.solver_inputs(model, kin, C.narrowphase(model, kin), qd, dt, eq)
        differ = [n for n, a, b in zip(names, got, want) if not torch.equal(a, b)]
        print(f"{label} contact rows, graph replay vs eager at state {i + 1} of {len(states)} (B={qd.shape[0]}, "
              f"dt={dt}): {'identical' if not differ else 'DIFFER in ' + ', '.join(differ)}")
        if differ:
            fail(f"{label}: the contact rows' graph replay differs from the eager code in {differ}")


def plain_unfused_substep(env, model, ctrl_state, phys):
    """One substep of the unfused path on the plain versions: forward_plain,
    the controllers, the smooth forces, the plain narrowphase and row
    compaction, vel_update_plain and the integration. -> (State, f)."""
    from robosuite_tpu_torch.ops import contact_solve, forward
    from robosuite_tpu_torch.physics import engine

    q, qd = phys.qpos, phys.qvel
    kin, M, bias = forward.forward_plain(model, q, qd, *forward.runtime_leaves(model, q.shape[0]))
    c = env.run_controllers(kin, M, bias, q, qd, ctrl_state)
    return engine.integrate(model, phys, c, kin, M, bias, solve=contact_solve.vel_update_plain)


# how far past the float32 reference's own error (against float64) an
# ill-conditioned solve's kernel result may lie and be set aside: float32
# APGD iterates that have not converged part ways by rounding
ILL_FACTOR = 10.0


def solve_conditioning_witness(args, bad, out_k, out_p, scales):
    """A float64 witness that K2 and its plain version disagree on the same
    float32 operands `args` only because the float32 solve is
    ill-conditioned there, for the scenarios `bad` (out_k, out_p: (qvel, f)
    of the kernel and the plain version; scales: their relative scales):
    the solve redone in float64 on those operands lies beyond K2's 1e-4
    from the plain float32 result, so the reference solve itself misses
    its exact answer by more than the hold asks, and the kernel lies
    within ILL_FACTOR times that distance of it (a box face landing flat on
    the table, its four corners at one depth, under a light body: the
    APGD's 30 float32 iterations part ways, in the JAX package's float32
    solve too). -> a description or None each."""
    import torch

    from robosuite_tpu_torch.ops import contact_solve

    idx = torch.as_tensor(bad, device=args[0].device)
    a64 = [a[idx].double().cpu() if torch.is_tensor(a) else a for a in args]
    q64, f64 = contact_solve.vel_update_plain(*a64)
    out = []
    for i, b in enumerate(bad):
        def apart(x, y):
            return max(float((x[0][b].double().cpu() - y[0][i]).abs().max()) / scales[0],
                       float((x[1][b].double().cpu() - y[1][i]).abs().max()) / scales[1])
        gap = max(float((out_k[0][b] - out_p[0][b]).abs().max()) / scales[0],
                  float((out_k[1][b] - out_p[1][b]).abs().max()) / scales[1])
        own, own_k = apart(out_p, (q64, f64)), apart(out_k, (q64, f64))
        out.append(f"ill-conditioned float32 solve: the plain version {own:.2e} from the float64 solve of the same "
                   f"operands, the kernel {own_k:.2e}, apart {gap:.2e} (relative)"
                   if own > 1e-4 and own_k <= ILL_FACTOR * own else None)
    return out


def held_unfused_substep(env, model, ctrl_state, phys, err, label="unfused substep"):
    """One substep of the unfused path on the kernels (K1, K2), each launch
    held against its plain version on the same operands: K1's poses (2e-5),
    M and bias (relative to their largest), K2's qvel (relative to max(1,
    its largest)) and f (relative), a K2 scenario past 1e-4 set aside only
    on solve_conditioning_witness (printed, counted in ASIDE); the largest
    of each kept in `err`. The same operations as engine.integrate, so the
    result is the main path's, bit for bit. -> (State, f)."""
    import torch

    from robosuite_tpu_torch.ops import contact_solve, forward
    from robosuite_tpu_torch.physics import contact as C
    from robosuite_tpu_torch.physics import engine

    q, qd, dt = phys.qpos, phys.qvel, model.timestep
    kin, M, bias = forward.forward_products(model, q, qd)
    kin_p, M_p, bias_p = forward.forward_plain(model, q, qd, *forward.model_leaves(model, q.shape[0]))
    rel = lambda a, b: max_err(a, b) / max(1.0, float(b.abs().max()))  # noqa: E731
    err["K1 poses"] = max(err["K1 poses"], max(max_err(getattr(kin, f), getattr(kin_p, f))
                                               for f, v in kin_p.__dict__.items() if v is not None))
    err["K1 M"], err["K1 bias"] = max(err["K1 M"], rel(M, M_p)), max(err["K1 bias"], rel(bias, bias_p))
    c = env.run_controllers(kin, M, bias, q, qd, ctrl_state)
    qfrc, extra = engine.total_smooth_force(model, q, qd, c, M, bias)
    JfT, aref, reg3, mu, active = C.contact_rows(model, kin, qd, dt, q)
    args = (M.contiguous(), JfT, aref.contiguous(), qfrc.contiguous(), qd.contiguous(),
            (model.dof_damping + extra).contiguous(), reg3.contiguous(), mu, active.contiguous(),
            *C.solver_iterations(model), dt)
    qv, f = contact_solve.vel_update(*args)
    qv_p, f_p = contact_solve.vel_update_plain(*args)
    scales = (max(1.0, float(qv_p.abs().max())), max(1.0, float(f_p.abs().max())))
    ev, ef = (qv - qv_p).abs().amax(dim=1) / scales[0], (f - f_p).abs().amax(dim=1) / scales[1]
    bad = torch.nonzero((ev > 1e-4) | (ef > 1e-4)).flatten().tolist()
    if 0 < len(bad) <= 64:
        for b, why in zip(bad, solve_conditioning_witness(args, bad, (qv, f), (qv_p, f_p), scales)):
            print(f"{label} K2 launch scenario {b}: qvel err {float(ev[b]):.3e}, f err {float(ef[b]):.3e} (relative); "
                  f"{why or 'NO float64 witness'}")
            if why:
                ev[b] = ef[b] = 0.0
                ASIDE.append(label)
    err["K2 qvel"], err["K2 f"] = max(err["K2 qvel"], float(ev.max())), max(err["K2 f"], float(ef.max()))
    return engine.State(qpos=engine.integrate_qpos(model, q, qv, dt), qvel=qv, time=phys.time + dt), f


def pose_rounding_witness(env, model, ctrl_state, phys, bad, out_k, out_p, tol_v=1e-3, tol_f=1e-4):
    """A float64 witness that an unfused substep's kernel and plain results
    differ only through their poses' float32 rounding, for the scenarios
    `bad` of the substep from phys under ctrl_state (out_k, out_p: (qpos,
    qvel, f) of the kernel and the plain substep): each version's solve
    redone in float64 on the CPU from its own float32 forward products (K1's,
    held to 2e-5 at every launch, or forward_plain's), with float64
    controllers' forces, contact rows and velocity update, lands within
    the hold's tolerances of that version (qvel tol_v, f tol_f of the
    largest |f|), while the two float64 results differ beyond them: the
    state's stiff contacts amplify a pose difference of float32 rounding
    (a pad squeezing a handle at 60 N); or that the float32 solve is
    ill-conditioned there: the plain version lies beyond the tolerances
    from the float64 solve from its own poses, and the kernel within
    ILL_FACTOR times that of its own (a hammer's head landing flat on the
    table; the JAX package's float32 solve parts from float64 there too).
    -> a description or None each."""
    import torch

    from robosuite_tpu_torch.envs.base import map_state
    from robosuite_tpu_torch.ops import contact_solve, forward
    from robosuite_tpu_torch.physics import contact as C
    from robosuite_tpu_torch.physics import engine
    from robosuite_tpu_torch.physics.equality import equality_rows
    from robosuite_tpu_torch.physics.state import KinData

    if id(model) not in _CPU64:
        _CPU64[id(model)] = (model, model.replace().double().to("cpu"))
    m64 = _CPU64[id(model)][1]
    idx = torch.as_tensor(bad, device=phys.qpos.device)
    q, qd = phys.qpos[idx].contiguous(), phys.qvel[idx].contiguous()
    ctrl = map_state(lambda x: x[idx], ctrl_state)
    q64, qd64 = q.double().cpu(), qd.double().cpu()
    scale = max(1.0, float(out_p[2].abs().max()))
    twins, pose_diff = [], None
    for kin, M, bias in (forward.forward_products(model, q, qd),
                         forward.forward_plain(model, q, qd, *forward.model_leaves(model, len(bad)))):
        c = env.run_controllers(kin, M, bias, q, qd, ctrl)
        kin64 = KinData(**{f: v.double().cpu() for f, v in kin.__dict__.items() if v is not None})
        M64, bias64 = M.double().cpu(), bias.double().cpu()
        qfrc, damp = engine.total_smooth_force(m64, q64, qd64, c.double().cpu(), M64, bias64)
        eq = equality_rows(m64, kin64, q64, qd64) if m64.neq else None
        rows = C.solver_inputs(m64, kin64, C.narrowphase(m64, kin64), qd64, m64.timestep, eq)
        twins.append(contact_solve.vel_update_plain(M64, rows[0], rows[1], qfrc, qd64, m64.dof_damping + damp,
                                                    *rows[2:], *C.solver_iterations(m64), m64.timestep))
        pose_diff = kin64.geom_xpos if pose_diff is None else (pose_diff - kin64.geom_xpos).abs().amax(dim=(1, 2))
    out = []
    for i, b in enumerate(bad):
        own = [max(float((o[1][b].double().cpu() - t[0][i]).abs().max()) / tol_v,
                   float((o[2][b].double().cpu() - t[1][i]).abs().max()) / scale / tol_f)
               for o, t in zip((out_k, out_p), twins)]
        apart = max(float((twins[0][0][i] - twins[1][0][i]).abs().max()) / tol_v,
                    float((twins[0][1][i] - twins[1][1][i]).abs().max()) / scale / tol_f)
        gap = max(float((out_k[1][b] - out_p[1][b]).abs().max()) / tol_v,
                  float((out_k[2][b] - out_p[2][b]).abs().max()) / scale / tol_f)
        if max(own) <= 1.0 < apart:
            out.append(f"float64 solves from K1's and from the plain poses (apart {float(pose_diff[i]):.1e} m) differ "
                       f"by {apart:.2f} x the tolerance, each version within {max(own):.2f} x of its own")
        elif 1.0 < own[1] and own[0] <= ILL_FACTOR * own[1]:  # the float32 solve misses its own float64 twin
            out.append(f"ill-conditioned float32 solve: the plain version {own[1]:.2f} x the tolerance from the "
                       f"float64 solve from its own poses, the kernel {own[0]:.2f} x from its own, apart {gap:.2f} x")
        else:
            print(f"scenario {b}, no float64 witness: the kernel {own[0]:.2f} x the tolerance from the float64 solve "
                  f"from its own poses, the plain version {own[1]:.2f} x, the two float64 solves {apart:.2f} x apart, "
                  f"the float32 results {gap:.2f} x")
            out.append(None)
    return out


def hold_unfused_steps(label, env, trail, actions, rewards, leaves, reward_fn=None, whole=True):
    """Each policy step of an unfused step_batch run (trail: its states,
    the reset's first), substep by substep: its K1 and K2 launches against
    their plain versions on the same operands, and (with `whole`) the
    kernel substep against the plain one (forward_plain + vel_update_plain)
    from the same input under hold_all's rule, then on from the kernel's
    output, whose last substep is step_batch's next state bit for bit; the
    reward of the plain poses of that state (env.reward, or reward_fn(step,
    next state, its plain kin))."""
    import torch

    from robosuite_tpu_torch.ops import forward
    from robosuite_tpu_torch.physics import engine

    model = env.model
    worst, worst_r, k_err = 0.0, 0.0, {"K1 poses": 0.0, "K1 M": 0.0, "K1 bias": 0.0, "K2 qvel": 0.0, "K2 f": 0.0}
    for i in range(len(trail) - 1):
        st = trail[i]
        kin, M, bias = engine.forward_products(model, st.physics.qpos, st.physics.qvel)
        ctrl_i = env._set_goals(kin, M, bias, st.physics.qpos, st.physics.qvel, st.ctrl, actions)
        ph = st.physics
        for j in range(env.n_substeps):
            pk, fk_ = held_unfused_substep(env, model, ctrl_i, ph, k_err, f"{label} step {i + 1} substep {j + 1}")
            if not whole:
                ph = pk
                continue
            pp, fp_ = plain_unfused_substep(env, model, ctrl_i, ph)
            out_k, out_p = (pk.qpos, pk.qvel, fk_), (pp.qpos, pp.qvel, fp_)
            worst = max(worst, hold_all(
                f"{label} step {i + 1} substep {j + 1}", model, ph.qpos, out_k, out_p, quiet=True,
                extra=lambda bad, c=ctrl_i, p=ph, k=out_k, q=out_p: pose_rounding_witness(env, model, c, p, bad, k, q)))
            ph = pk
        nxt = trail[i + 1]
        if not (torch.equal(ph.qpos, nxt.physics.qpos) and torch.equal(ph.qvel, nxt.physics.qvel)):
            fail(f"{label} policy step {i + 1}: step_batch differs from its substep-by-substep kernel run")
        kin_p = forward.forward_plain(model, ph.qpos, ph.qvel, *leaves)[0]
        want_r = env.reward(nxt.physics, kin_p) if reward_fn is None else reward_fn(i, nxt, kin_p)
        worst_r = max(worst_r, max_err(rewards[i], want_r))
    torch.cuda.synchronize()
    steps = len(trail) - 1
    print(f"{label} {steps} policy steps x {env.n_substeps} substeps, kernel vs plain from the same input: "
          + (f"largest qpos / qvel error held {worst:.3e}" if whole else "every launch held, not the whole substep"))
    for name, tol in (("K1 poses", 2e-5), ("K1 M", 1e-5), ("K1 bias", 1e-4), ("K2 qvel", 1e-4), ("K2 f", 1e-4)):
        check(f"{label} {steps} policy steps: every {name[:2]} launch against its plain version on its own "
              f"operands, {name[3:]}{' (relative)' if name != 'K1 poses' else ''}", k_err[name], tol)
    check(f"{label} {steps} policy steps: reward (K1 vs plain poses of the same state)", worst_r, 1e-4)


def unfused_k1(tag, name, model, states, widths, world_k, results):
    """K1 on an unfused world's reset states at each of `widths` against
    its plain version (hold_k1), timed at each width above 1 into
    results["k1_widths"]; the first width's times into world_k["K1"]."""
    from robosuite_tpu_torch.ops import forward

    k1_err, rows = 0.0, []
    for n in widths:
        q, qd = states.physics.qpos[:n], states.physics.qvel[:n]
        k1_err = max(k1_err, hold_k1(f"{name} K1 (B={n})", model, q, qd))
        if n > 1:
            rows.append(dict(world=name, **time_width(
                tag, f"K1 {name}", lambda: forward.forward_products(model, q, qd),
                lambda: forward.forward_plain(model, q, qd, *forward.model_leaves(model, n)), 20, k1_bytes(model, n),
                op_counts(model, 0)["K1"], n)))
    results.setdefault("k1_widths", []).extend(rows)
    world_k["K1"] = dict(max_abs_err=k1_err, ms=rows[0]["ms"], dev_ms=rows[0]["dev_ms"], plain_ms=rows[0]["plain_ms"],
                         bound=(rows[0]["bound_ms"], rows[0]["bound_by"]))


def unfused_k2(name, env, states, s, kin, M, bias, con, K, world_k):
    """K2 at an unfused world's width (K rows or compacted slots), on the
    plain path's operands at the contact state s (kin, M, bias, con: its
    plain forward products and narrowphase), against its plain version:
    qvel relative to max(1, its largest) (a light body, PickPlaceCan's 14 g
    can, turns f's float32 rounding into velocity), f relative to its
    largest; timed into world_k["K2"]. A world with equality constraints
    has its ne rows after the 3 K contact rows. Before it, the contact rows'
    CUDA graph against the eager code at the reset (states) and at s."""
    import torch

    from robosuite_tpu_torch.ops import contact_solve, forward
    from robosuite_tpu_torch.physics import contact as C
    from robosuite_tpu_torch.physics import engine
    from robosuite_tpu_torch.physics.equality import equality_row_count, equality_rows

    model = env.model
    q, qd = s.physics.qpos, s.physics.qvel
    ne = equality_row_count(model)
    ctrl = env.run_controllers(kin, M, bias, q, qd, s.ctrl)
    qfrc, extra = engine.total_smooth_force(model, q, qd, ctrl, M, bias)
    eq = equality_rows(model, kin, q, qd) if ne else None
    JfT, aref, reg3, mu, act = C.solver_inputs(model, kin, con, qd, model.timestep, eq)
    if JfT.shape != (B, model.nv, 3 * K + ne):
        fail(f"{name} solver operands {tuple(JfT.shape)}, not ({B}, {model.nv}, {3 * K + ne})")
    leaves = forward.runtime_leaves(model, B)
    kin0 = forward.forward_plain(model, states.physics.qpos, states.physics.qvel, *leaves)[0]
    hold_rows_graph(name, model, [(kin0, states.physics.qvel, states.physics.qpos), (kin, qd, q)], model.timestep)
    args = (M.contiguous(), JfT, aref.contiguous(), qfrc.contiguous(), qd.contiguous(),
            (model.dof_damping + extra).contiguous(), reg3.contiguous(), mu, act.contiguous())
    nact = float(act.sum(1).float().mean())
    solve_args = (C.APGD_ITERS, C.POWER_ITERS, model.timestep)
    qv_k, f_k = contact_solve.vel_update(*args, *solve_args)
    qv_p, f_p = contact_solve.vel_update_plain(*args, *solve_args)
    torch.cuda.synchronize()
    v_scale = max(1.0, float(qv_p.abs().max()))
    print(f"{name} K2 (nv {model.nv}, {K} rows, {nact:.1f} active on average, {ne} equality rows): qvel max_abs_err "
          f"{max_err(qv_k, qv_p):.3e}, largest |qvel| {v_scale:.3f}")
    check(f"{name} K2 qvel (relative to max(1, |qvel|))", max_err(qv_k, qv_p) / v_scale, 1e-4)
    check(f"{name} K2 f (relative)", max_err(f_k, f_p) / max(1.0, float(f_p.abs().max())), 1e-4)
    world_k["K2"] = dict(max_abs_err=max(max_err(qv_k, qv_p), max_err(f_k, f_p)),
                         ms=cuda_ms(lambda: contact_solve.vel_update(*args, *solve_args), 20),
                         dev_ms=device_ms(lambda: contact_solve.vel_update(*args, *solve_args), 20),
                         plain_ms=cuda_ms(lambda: contact_solve.vel_update_plain(*args, *solve_args), 3),
                         bound=bound(nbytes(*args, qv_k, f_k), op_counts(model, K, nact, ne=ne)["K2"], B), ne=ne,
                         nact=nact)
    phase_done(f"{name} K2 vs plain")


def valid_resets(env, n, gen, rounds=20):
    """reset_batch(n, gen), with every scenario whose placement the reset
    flags invalid (obs["placement_valid"] False: an object found no clear
    spot, where robosuite's reset raises RandomizationError and is tried
    again) drawn again from gen, up to `rounds` more calls; ToolHang's
    ranges leave its wrench no clear spot in about a third of the draws,
    and its overlapping objects can throw the wrench at hundreds of rad/s
    (float64 too). -> (states, obs, the reset_batch calls made)."""
    import torch

    from robosuite_tpu_torch.envs.base import map_state

    states, obs = env.reset_batch(n, gen)
    calls = 1
    while not bool(obs["placement_valid"].all()):
        if calls > rounds:
            fail(f"{type(env).__name__}: invalid placements left after {rounds} redraws")
        idx = torch.nonzero(~obs["placement_valid"]).flatten()
        fresh, fobs = env.reset_batch(len(idx), gen)
        calls += 1
        leaves = []
        map_state(lambda x: leaves.append(x) or x, fresh)
        it = iter(leaves)
        states = map_state(lambda x: x.index_copy(0, idx, next(it)), states)
        obs = {k: v.index_copy(0, idx, fobs[k]) for k, v in obs.items()}
    return states, obs, calls


def unfused_step_slice(tag, name, env, gen, results, key, actions=None, full=True, steps=STEPS, held=None,
                       whole=True):
    """The step slice of an unfused world: counts zeroed, reset_batch + `steps`
    (STEPS) step_batch policy steps at B (K1 for the goals, one a substep and one
    for the observations; K2 one a substep; no K3), finite observations and
    rewards, the reset's keys, a proprio modality per robot, the eef force
    zero on a world that compacts its rows (the JAX package's is 0 there),
    done only at the horizon (an env with its own step hook, Wipe, may end
    episodes early, add keys and replace the reward); host-clock rates with
    the reset, and, with `full`, over STEPS more steady steps and a profiled
    step; then every substep held (hold_unfused_steps; with a step hook,
    the reward held is the hook's) over the policy steps (with `full`) or
    the first EARLIER_HELD (or the first `held`, where given), with the
    count of cases set aside; without `whole`, each substep's launches
    only (hold_unfused_steps).
    The actions: small random deltas, or `actions`.
    -> (the launch counts of the reset + steps, the last states, the step
    outputs (trail, obs, dones))."""
    import torch

    from robosuite_tpu_torch.envs.base import RobotEnv
    from robosuite_tpu_torch.ops import forward
    from robosuite_tpu_torch.physics import contact as C

    hooked = type(env)._step_hook is not RobotEnv._step_hook
    if actions is None:
        actions = torch.clamp(0.3 * torch.randn(B, env.action_dim, generator=gen, device="cuda"), -1.0, 1.0)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states, obs0, calls = valid_resets(env, B, gen)
    trail, rewards, dones, obs_all = [states], [], [], []
    for _ in range(steps):
        states, obs, r, done, _ = env.step_batch(states, actions)
        trail.append(states)
        rewards.append(r)
        dones.append(done)
        obs_all.append(obs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kcounts()
    take_widths(name)
    print(f"{name} main path launches over reset ({calls} reset_batch calls) + {steps} step_batch policy steps: "
          f"{counts}")
    if counts != {"K1": calls + (env.n_substeps + 2) * steps, "K2": env.n_substeps * steps, "K3": 0, "K3-aux": 0,
                  "K4": 0}:
        fail(f"unexpected {name} launch counts {counts}")
    rew = torch.stack(rewards)
    if not (all(torch.isfinite(v.float()).all() for o in obs_all for v in o.values()) and torch.isfinite(rew).all()):
        fail(f"non-finite observations or rewards on the {name} path")
    keys, reset_keys = set(obs_all[-1]), set(obs0) - {"placement_valid"}
    if not hooked and (any(bool(d.any()) for d in dones) or keys != reset_keys) or not keys >= reset_keys:
        fail(f"{name} step_batch: done before the horizon, or observation keys other than the reset's")
    for i in range(len(env.robots)):
        if obs_all[-1][f"robot{i}_proprio-state"].shape[0] != B:
            fail(f"{name} step_batch: no robot{i}_proprio-state")
        if C.uses_row_compaction(env.model) and any(bool(o[f"robot{i}_eef_force"].any()) for o in obs_all):
            fail(f"{name} step_batch: an eef force on a world that compacts its rows (the JAX package's is 0)")
    print(f"{tag} {name} env policy-steps/s (B={B}, host clock): {B * steps / dt:.1f} with the reset (reset + "
          f"{steps} steps); rewards mean {float(rew.mean()):.4f} max {float(rew.max()):.4f}")
    results.update({f"{key}_policy_steps_per_s_with_reset": B * steps / dt, f"{key}_launches": counts})
    if full:
        t1 = time.perf_counter()
        steady = states
        for _ in range(STEPS):
            steady = env.step_batch(steady, actions)[0]
        torch.cuda.synchronize()
        dt_steady = time.perf_counter() - t1
        print(f"{tag} {name} env policy-steps/s (B={B}, host clock): {B * STEPS / dt_steady:.1f} steady ({STEPS} "
              f"step_batch steps after the run)")
        _, wall_ms, dev_ms, top, port = profile_once(tag, f"one {name} step_batch policy step",
                                                     lambda: env.step_batch(states, actions), 8)
        results.update({f"{key}_policy_steps_per_s": B * STEPS / dt_steady, f"{key}_profile_wall_ms": wall_ms,
                        f"{key}_profile_device_ms": dev_ms, f"{key}_profile_top": top, f"{key}_profile_port": port})
    held = min(steps, held if held is not None else steps if full else EARLIER_HELD)
    before = len(ASIDE)
    reward_fn = None
    if hooked:  # the step hook's reward, from the step's input state and its observations
        def reward_fn(i, nxt, kin_p):
            zero = torch.zeros_like(rewards[i])
            return env._step_hook(trail[i], nxt, dict(obs_all[i]), zero, dones[i], kin_p)[2]
    hold_unfused_steps(name, env, trail[:held + 1], actions, rewards, forward.runtime_leaves(env.model, B), reward_fn,
                       whole)
    print(f"{name} step slice: {len(ASIDE) - before} (substep, scenario) cases set aside on a float64 witness, "
          f"of {held * env.n_substeps * B} (the first {held} of {steps} steps held)")
    results[f"{key}_set_aside"] = len(ASIDE) - before
    phase_done(f"{name} step slice (reset + step_batch steps, profile, kernel vs plain)")
    return counts, states, (trail, obs_all, dones)


def unfused_mpc(tag, name, env, mpc_cfg, batch, ticks, gm, gs, results, key, held_states, world_k, full=True):
    """The MPPI-only MPC of an unfused world at tools/bench_configs.py's
    width (mpc_cfg, `batch` solves): a warm-up tick, then `ticks` ticks
    timed with the launches the config implies (the planning rollouts: K1
    at the start, then per planned step one a substep and one for the
    step's end; the executed step as in the step slice), finite actions in
    [-1, 1], peak memory and, with `full`, a profiled tick (the device alone); the
    planning rollouts' rows graph (batch x samples, the planning dt)
    against the eager code at each of held_states; then world_k's kernel
    times. gm draws the reset, gs the MPPI noise. -> the launch counts."""
    import torch

    from robosuite_tpu_torch.mpc import receding
    from robosuite_tpu_torch.ops import forward

    cfg = receding.MPCConfig(**mpc_cfg)
    mpc = receding.RecedingMPC(env, cfg)
    solve = mpc.make_solve_batch()
    mstates = valid_resets(env, batch, gm)[0]
    ms = mpc.init_state(batch, gs)

    def tick(states_, ms_):
        acts, ms2, met = solve(states_, ms_)
        states2, rewards_ = env.rollout_batch(states_, acts)
        return states2, ms2, met, acts, rewards_

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mstates, ms, met, acts, rew = tick(mstates, ms)
    torch.cuda.synchronize()
    print(f"{tag} {name} MPC warm-up tick s: {time.perf_counter() - t0:.3f}")
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    H, n_plan = cfg.horizon, mpc.plan_substeps
    want = {"K1": 1 + H * (n_plan + 1) + env.n_substeps + 2, "K2": H * n_plan + env.n_substeps, "K3": 0,
            "K3-aux": 0, "K4": 0}
    for i in range(ticks):
        before = kcounts()
        mstates, ms, met, acts, rew = tick(mstates, ms)
        after = kcounts()
        got = {k: after[k] - before[k] for k in after}
        print(f"{name} MPC tick {i + 1} launches: {got}")
        if got != want:
            fail(f"{name} MPC tick {i + 1}: launches {got}, the config implies {want}")
        if not (torch.isfinite(acts).all() and acts.abs().max() <= 1.0 and torch.isfinite(rew).all()):
            fail(f"{name} MPC tick {i + 1}: non-finite or out-of-range actions, or non-finite rewards")
    torch.cuda.synchronize()
    mpc_dt = time.perf_counter() - t0
    mpc_counts = kcounts()
    take_widths(name)
    plan, n_roll = mpc.plan_model, batch * cfg.n_samples
    if (str(plan.device), ("rows_graph", n_roll, float(plan.timestep))) not in plan.__dict__.get("_derived", {}):
        fail(f"the {name} planning rollouts built no contact rows graph at B={n_roll}, dt={plan.timestep}")
    pleaves = forward.runtime_leaves(plan, n_roll)
    hold_rows_graph(f"{name} planning", plan,
                    [(forward.forward_plain(plan, st.physics.qpos[:n_roll], st.physics.qvel[:n_roll], *pleaves)[0],
                      st.physics.qvel[:n_roll], st.physics.qpos[:n_roll]) for st in held_states], plan.timestep)
    solves = batch * ticks / mpc_dt
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"{tag} {name} MPC solves/s (B={batch}, H={cfg.horizon}, K={cfg.n_samples}, MPPI only, unfused; "
          f"ticks 1-{ticks}, host clock): {solves:.2f}; mean executed reward {float(rew.mean()):.4f}; peak "
          f"device memory {peak_gb:.2f} GB")
    results.update({f"{key}_mpc_solves_per_s": solves, f"{key}_mpc_launches": mpc_counts,
                    f"{key}_mpc_peak_gb": peak_gb})
    if full:
        _, wall_ms, dev_ms, top, port = profile_once(tag, f"one {name} MPC tick", lambda: tick(mstates, ms), 8,
                                                     kernels_only=True)
        results.update({f"{key}_mpc_profile_wall_ms": wall_ms, f"{key}_mpc_profile_device_ms": dev_ms,
                        f"{key}_mpc_profile_top": top, f"{key}_mpc_profile_port": port})
    for k, r in world_k.items():
        print(f"{tag} {name} {k}: {r['ms']:.4f} ms/launch at B={B} ({r['dev_ms']:.4f} ms device), plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound'][0]:.5f} ms ({r['bound'][1]})")
    phase_done(f"{name} MPC at full width")
    return mpc_counts


def pickplace_slice(tag, results):
    """Phases 23-27, Sawyer + PickPlaceCan with the JOINT_POSITION arm, on
    the unfused path (K1, the plain narrowphase over 606 pairs and the row
    compaction into 96 slots, K2; no K3). -> the launch counts of the env
    step (reset + STEPS step_batch policy steps) and of the MPC ticks."""
    import torch

    import robosuite_tpu_torch as R
    from robosuite_tpu_torch import ab_kernels
    from robosuite_tpu_torch.ops import build, forward, substep
    from robosuite_tpu_torch.physics import contact as C

    # ---- 23. the world, the fused gate, K1 at its widths
    env = R.make("PickPlaceCan", robots="Sawyer", controller_configs="JOINT_POSITION", reward_shaping=True)
    model = env.model
    nrows = sum(len(r) for r in C.contact_row_layout(model).values())
    groups = {f"{S_NAMES[a]}-{S_NAMES[b]}": len(v) for (a, b), v in sorted(C.pair_groups(model).items())}
    print(f"PickPlaceCan world: nq={model.nq} nv={model.nv} nbody={model.nbody} ngeom={model.ngeom} "
          f"nsite={model.nsite} npair={model.npair} candidate points (rows)={nrows}, compacted into "
          f"{C.ROW_CAP} slots; pairs by type {groups}")
    if (model.nq, model.nv, model.nbody, model.ngeom, model.npair, nrows) != (37, 33, 40, 105, 606, 1326):
        fail("the PickPlaceCan world is not nq 37, nv 33, 40 bodies, 105 geoms, 606 pairs, 1326 rows")
    try:
        substep.extract_spec(env, model)
        fail("the fused substep's gate takes PickPlaceCan")
    except substep.UnsupportedFused as e:
        print(f"PickPlaceCan fused gate: UnsupportedFused({e}); uses_row_compaction "
              f"{C.uses_row_compaction(model)} (nv * 3 * rows = {model.nv * 3 * nrows} > {C.ROW_VMEM_BUDGET})")
        if not C.uses_row_compaction(model) or "compacts" not in str(e):
            fail("the fused gate does not refuse PickPlaceCan by its row compaction")
    if env._fused_for(model) is not None:
        fail("the PickPlaceCan env has a fused substep")
    lib = build.library()
    k1_smem = lib.rs_forward_smem_bytes(forward.model_tables(model)[1].data_ptr())
    k2_smem = lib.rs_contact_solve_smem_bytes(model.nv, C.ROW_CAP, 0)
    print(f"PickPlaceCan shared memory a block: K1 {k1_smem} B ({k1_smem // 4} words, 4 scenarios), K2 {k2_smem} B "
          f"(2 scenarios at nv {model.nv}, {C.ROW_CAP} slots)")
    results["smem_bytes"].update({"K1 PickPlaceCan block": k1_smem, "K2 PickPlaceCan block": k2_smem})
    pick_k = results.setdefault("pick_kernels", {})
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    states, obs = env.reset_batch(B, gen)
    if not all(torch.isfinite(v.float()).all() for v in obs.values()):
        fail("PickPlaceCan reset: non-finite observations")
    unfused_k1(tag, "PickPlaceCan", model, states, (B, PICK_B), pick_k, results)
    phase_done("PickPlaceCan world, gate, K1")

    # ---- 24. the contact state: the pads closed on the can, the objects in bin 1
    s = ab_kernels.pickplace_contact_state(env, states)
    q, qd = s.physics.qpos, s.physics.qvel
    if not (torch.isfinite(q).all() and torch.isfinite(qd).all()):
        fail("the PickPlaceCan contact state is not finite")
    leaves = forward.runtime_leaves(model, B)
    kin, M, bias = forward.forward_plain(model, q, qd, *leaves)
    con = C.narrowphase(model, kin)
    n_act = (con["dist"] < con["margin"]).sum(1)
    grip = sum(env.robot_models[0].grippers["right"].important_geoms.values(), [])
    can_rows = [r for k in env._contact_pairs(grip, env.objects[3].contact_geoms) for r in C.contact_row_layout(model)[k]]
    rich, dropped = int((n_act >= 4).sum()), int((n_act > C.ROW_CAP).sum())
    print(f"PickPlaceCan contact state: active rows per scenario min {int(n_act.min())} median "
          f"{int(n_act.median())} max {int(n_act.max())} (of {nrows}); >= 4 active in {rich}/{B}; the "
          f"{C.ROW_CAP}-slot cap drops rows in {dropped}/{B}; a pad or finger on the can in "
          f"{int(((con['dist'][:, can_rows] < 0).sum(1) > 0).sum())}/{B}")
    if 2 * rich < B:
        fail(f"the PickPlaceCan contact state is too poor: {rich}/{B} scenarios with >= 4 active rows")
    phase_done("PickPlaceCan contact state")

    # ---- 25. K2 at nv 33 and 96 compacted slots, on the plain path's operands
    unfused_k2("PickPlaceCan", env, states, s, kin, M, bias, con, C.ROW_CAP, pick_k)

    # ---- 26. the step slice: reset_batch + 10 step_batch policy steps, unfused
    counts, states, _ = unfused_step_slice(tag, "PickPlaceCan", env, gen, results, "pick", full=False)

    # ---- 27. the MPC at tools/bench_configs.py's width: B=32, H=128, K=16, MPPI only
    mpc_counts = unfused_mpc(tag, "PickPlaceCan", env, PICK_MPC, PICK_B, PICK_TICKS,
                             torch.Generator(device="cuda").manual_seed(SEED + 41),
                             torch.Generator(device="cuda").manual_seed(SEED + 42), results, "pick", (states, s),
                             pick_k, full=False)
    return counts, mpc_counts


# tools/bench_configs.py's H=64 rows (MPPI only; unfused): B=32 solves, K=16
H64_MPC = dict(horizon=64, n_samples=16, noise_sigma=0.4, temperature=0.2, n_knots=8, n_ilqr_iters=0,
               plan_timestep=0.025)
H64_B = 32
EARLIER_HELD = 2  # policy steps held substep by substep on the unfused worlds cut in depth
VARIABLE_KP = {"right": {"type": "OSC_POSE", "impedance_mode": "variable_kp"}}


def _twoarm_lift_rich(env, kin, n_act):
    grasps = [env.check_grasp(kin, *pairs) for pairs in env._grasp_pairs]
    both, rich = int((grasps[0] & grasps[1]).sum()), int((n_act >= 4).sum())
    return (f"both grippers grasp their handles in {both}/{B}; >= 4 active rows in {rich}/{B}",
            2 * both >= B and 2 * rich >= B)


def _peg_touches(env, kin, n_act):
    touch = int((n_act >= 1).sum())
    cos = env._peg_alignment(kin)[2]
    return (f"the peg's tip on the hole's side in {touch}/{B}; |cos| of the peg's axis with the hole's normal median "
            f"{float(cos.abs().median()):.4f}", 4 * touch >= 3 * B)


def _nut_grasped(env, kin, n_act):
    grasp, rich = int(env.check_grasp(kin, *env._grasp_pairs_per_nut[0]).sum()), int((n_act >= 4).sum())
    return (f"the pads grasp the square nut in {grasp}/{B}; >= 4 active rows in {rich}/{B}",
            2 * grasp >= B and 2 * rich >= B)


def _tool_pressed(env, kin, n_act):
    touch = int(env._any_contact(kin, env._tool_table_pairs).sum())
    arm = int(env._any_contact(kin, env._arm_collision_pairs).sum())
    rich = int((n_act >= 4).sum())
    return (f"the tool on the table in {touch}/{B}, an arm link touching in {arm}/{B}; >= 4 active rows in "
            f"{rich}/{B}", 2 * touch >= B and 2 * rich >= B and not arm)


def _handover_grasp(env, kin, n_act):
    grasp = int(env.check_grasp(kin, *env._grasp0).sum())
    return f"both of robot0's pads on the hammer's handle in {grasp}/{B}", 2 * grasp >= B


def _tool_hang_rich(env, kin, n_act):
    grip = sum(env.robot_models[0].grippers["right"].important_geoms.values(), [])
    objs = env.stand.contact_geoms + env.frame.contact_geoms + env.tool.contact_geoms
    touch = int(env._any_contact(kin, env._contact_pairs(grip, objs)).sum())
    rich = int((n_act >= 8).sum())
    return (f"a pad or finger on an object in {touch}/{B}; >= 8 active rows in {rich}/{B}",
            2 * touch >= B and 2 * rich >= B)


def _transport_rich(env, kin, n_act):
    lid = int(env.check_grasp(kin, *env.grasp_pairs("right", env.lid.handle_geoms, robot_idx=0)).sum())
    rich = int((n_act >= 8).sum())
    return f"robot0's pads on the lid's handle in {lid}/{B}; >= 8 active rows in {rich}/{B}", 2 * rich >= B


# the unfused Panda worlds of phases 28-49 and 51-65: make's keywords, (nq,
# nv, nbody, ngeom, nsite, nu, npair, candidate rows), the function of
# ab_kernels that makes its contact state and the check of that state, the
# first phase's number, what the fused gate refuses it for, K1's widths, the
# MPC's timed ticks (one since the last three worlds came), and whether its
# paths run in full (all 10 steps held substep by substep, the steady rate
# and the profiled step and tick) or cut in depth (EARLIER_HELD steps held,
# no steady rate or profiles): every world here runs cut, so that the run
# keeps within its time with the arm controllers' phases 71-80
TWO_PANDAS = dict(robots=("Panda", "Panda"), env_configuration="opposed")
UNFUSED_WORLDS = {
    "TwoArmLift": (TWO_PANDAS, (25, 24, 47, 170, 19, 18, 170, 620), "twoarm_lift_contact_state", _twoarm_lift_rich,
                   28, "one fixed-base robot", (B, H64_B, 1), 1, False),
    "TwoArmPegInHole": (TWO_PANDAS, (14, 14, 40, 136, 19, 14, 39, 117), "peg_contact_state", _peg_touches, 33,
                        "one fixed-base robot", (B, H64_B, 1), 1, False),
    "NutAssemblySingle": (dict(robots="Panda"), (23, 21, 31, 104, 20, 9, 186, 680), "nut_contact_state",
                          _nut_grasped, 38, "compacts", (B, H64_B), 1, False),
    "Wipe": (dict(robots="Panda", controller_configs=VARIABLE_KP, num_markers=4, seed=1),
             (7, 7, 25, 116, 16, 7, 175, 448), "wipe_contact_state", _tool_pressed, 44, "compacts", (B, H64_B), 1,
             False),
    "TwoArmHandover": (TWO_PANDAS, (25, 24, 47, 161, 17, 18, 62, 203), "handover_contact_state", _handover_grasp,
                       51, "one fixed-base robot", (B, H64_B, 1), 1, False),
    "ToolHang": (dict(robots="Panda"), (30, 27, 28, 102, 14, 9, 172, 656), "tool_hang_contact_state",
                 _tool_hang_rich, 56, "compacts", (B, H64_B), 1, False),
    "TwoArmTransport": (TWO_PANDAS, (39, 36, 53, 170, 23, 18, 250, 905), "transport_contact_state",
                        _transport_rich, 61, "one fixed-base robot", (B, H64_B, 1), 1, False),
}


def unfused_world_slice(tag, results, name):
    """Phases 28-32 (TwoArmLift), 33-37 (TwoArmPegInHole), 38-43
    (NutAssemblySingle), 44-49 (Wipe), 51-55 (TwoArmHandover), 56-60
    (ToolHang) or 61-65 (TwoArmTransport) on the unfused path (K1, the
    contact rows as a CUDA graph, K2; no K3: the fused gate refuses two
    robots or a world that compacts its rows, as the JAX package's does).
    -> the launch counts of the env step (reset + STEPS step_batch policy
    steps) and of the MPC ticks."""
    import torch

    import robosuite_tpu_torch as R
    from robosuite_tpu_torch import ab_kernels
    from robosuite_tpu_torch.ops import forward
    from robosuite_tpu_torch.physics import contact as C

    kw, sizes, state_fn, state_check, ph, refusal, k1_widths, ticks, full = UNFUSED_WORLDS[name]
    # ---- 28 / 33 / 38 / 44 / 51 / 56 / 61. the world, the fused gate, K1 at its widths
    env = R.make(name, reward_shaping=True, **kw)
    model = env.model
    nrows = sum(len(r) for r in C.contact_row_layout(model).values())
    compacts = C.uses_row_compaction(model)
    K = min(C.ROW_CAP, nrows) if compacts else nrows
    groups = {f"{S_NAMES[a]}-{S_NAMES[b]}": len(v) for (a, b), v in sorted(C.pair_groups(model).items())}
    got = (model.nq, model.nv, model.nbody, model.ngeom, model.nsite, model.nu, model.npair, nrows)
    print(f"{name} world: nq={got[0]} nv={got[1]} nbody={got[2]} ngeom={got[3]} nsite={got[4]} nu={got[5]} "
          f"npair={got[6]} candidate points (rows)={nrows}, "
          f"{f'compacted into {K} slots' if compacts else 'static rows'}; pairs by type {groups}; "
          f"action_dim {env.action_dim}")
    if got != sizes:
        fail(f"the {name} world is {got}, not {sizes} (nq, nv, nbody, ngeom, nsite, nu, npair, rows)")
    print(f"{name} uses_row_compaction {compacts}")
    refused_by_gate(name, env, model, refusal)
    unfused_smem(name, model, K, 0, results)
    world_k = results.setdefault("unfused_kernels", {}).setdefault(name, {})
    gen = torch.Generator(device="cuda").manual_seed(SEED + ph)
    states, obs, _ = valid_resets(env, B, gen)
    if not all(torch.isfinite(v.float()).all() for v in obs.values()):
        fail(f"{name} reset: non-finite observations")
    unfused_k1(tag, name, model, states, k1_widths, world_k, results)
    phase_done(f"{name} world, gate, K1")

    # ---- 29 / 34 / 40 / 46 / 52 / 57 / 62. the contact state
    s = getattr(ab_kernels, state_fn)(env, states)
    q, qd = s.physics.qpos, s.physics.qvel
    if not (torch.isfinite(q).all() and torch.isfinite(qd).all()):
        fail(f"the {name} contact state is not finite")
    kin, M, bias = forward.forward_plain(model, q, qd, *forward.runtime_leaves(model, B))
    con = C.narrowphase(model, kin)
    n_act = (con["dist"] < con["margin"]).sum(1)
    print(f"{name} contact state: active rows per scenario min {int(n_act.min())} median {int(n_act.median())} "
          f"max {int(n_act.max())} (of {nrows}); the {K}-slot cap drops rows in {int((n_act > K).sum())}/{B}")
    report, rich_enough = state_check(env, kin, n_act)
    print(f"{name} contact state: {report}")
    if not rich_enough:
        fail(f"the {name} contact state is too poor: {report}")
    phase_done(f"{name} contact state")
    if name == "TwoArmPegInHole":
        tangent_checks(tag, name, env, None, s, 64, results)

    # ---- 30 / 35 / 41 / 47 / 53 / 58 / 63. K2 at the world's width, on the plain path's operands; the rows' graph
    unfused_k2(name, env, states, s, kin, M, bias, con, K, world_k)

    # ---- 31 / 36 / 42 / 48 / 54 / 59 / 64. the step slice: reset_batch + 10 step_batch policy steps, unfused
    wipe = name == "Wipe"
    actions = None
    if wipe:  # the gains at their limit, the tool driven down at full speed (0.25 m to the table: ~0.1 m left
        # after 10 steps; a few arms come near a joint limit, the unsafe branch)
        actions = torch.clamp(0.2 * torch.randn(B, env.action_dim, generator=gen, device="cuda"), -1.0, 1.0)
        actions[:, :6] = 300.0
        actions[:, 8] = -1.0
    counts, states, (trail, obs_all, dones) = unfused_step_slice(tag, name, env, gen, results, name.lower(), actions,
                                                                 full)
    if wipe:
        ts = trail[-1].task_state
        early = int(torch.stack(dones).any(dim=0).sum())
        unsafe = int((ts.collisions > 0).sum())
        wiped = int(ts.wiped.any(dim=-1).sum())
        print(f"{name} step slice: done early in {early}/{B}, an unsafe step in {unsafe}/{B}, a marker wiped in "
              f"{wiped}/{B}, every marker in {int(ts.wiped.all(dim=-1).sum())}/{B}; wiped_markers "
              f"{tuple(obs_all[-1]['wiped_markers'].shape)}")
        results["wipe_step_shares"] = dict(done_early=early, unsafe=unsafe, any_wiped=wiped, batch=B)

    # ---- 32 / 37 / 43 / 49 / 55 / 60 / 65. the MPC at tools/bench_configs.py's width: B=32, H=64, K=16, MPPI only
    mpc_counts = unfused_mpc(tag, name, env, H64_MPC, H64_B, ticks,
                             torch.Generator(device="cuda").manual_seed(SEED + ph + 1),
                             torch.Generator(device="cuda").manual_seed(SEED + ph + 2), results, name.lower(),
                             (states, s), world_k, full)
    if name != "TwoArmPegInHole":
        return counts, mpc_counts
    # ---- 69-70. its MPC with the AD linearization (K2's tangent rule), beside the FD one; nx with the pad
    ad_counts, mpc, _ = ad_mpc(tag, name, env, dict(H64_MPC, fd_timestep=0.05), H64_B, results, name.lower(),
                               SEED + ph + 3, SEED + ph + 4)
    print(f"{name} iLQR state x: nx {mpc.nx} (qpos {model.nq}, qvel {model.nv}, one ramp entry a null gripper)")
    if mpc.nx != 30:
        fail(f"the TwoArmPegInHole iLQR state is {mpc.nx} wide, not 30 (the JAX package's)")
    phase_done(f"{name} AD-linearized MPC")
    return counts, mpc_counts, ad_counts


def variable_gains_check(results):
    """Phase 50: a fused world (Lift) with the variable_kp OSC: K3 against
    its plain version with each scenario's own gains from its action, at a
    reset state (qpos 1e-5, qvel 1e-3, as phase 6)."""
    import torch

    import robosuite_tpu_torch as R
    from robosuite_tpu_torch.ops import forward, substep
    from robosuite_tpu_torch.physics import engine

    env = R.make("Lift", robots="Panda", reward_shaping=True, controller_configs=VARIABLE_KP)
    model, robot = env.model, env.robots[0]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    s, _ = env.reset_batch(B, gen)
    a = torch.clamp(0.5 * torch.randn(B, env.action_dim, generator=gen, device="cuda"), -1.0, 1.0)
    a[:, :6] = 300.0 * torch.rand(B, 6, generator=gen, device="cuda")
    q, qd = s.physics.qpos, s.physics.qvel
    kin, M, bias = engine.forward_products(model, q, qd)
    ctrl = env._set_goals(kin, M, bias, q, qd, s.ctrl, a)
    goal, gains = env._fused_goal_fn(robot, "right", ctrl, kin)
    if not (torch.equal(gains[:, :6], a[:, :6]) and float(gains[:, :6].std(dim=0).min()) > 10.0):
        fail("the variable_kp gains rows are not each scenario's own")
    fused = env._fused_for(model)
    args = (q, qd, *forward.runtime_leaves(model, B), goal, gains, robot.gripper_ctrl("right", ctrl).contiguous())
    qp_k, qv_k, _ = fused(*args)
    qp_p, qv_p, _ = substep.substep_plain(env, model, *args)
    torch.cuda.synchronize()
    print(f"variable_kp Lift (B={B}, per-scenario kp in [0, 300]): K3 vs plain qpos {max_err(qp_k, qp_p):.3e}, "
          f"qvel {max_err(qv_k, qv_p):.3e}")
    check("K3 qpos with per-scenario variable_kp gains", max_err(qp_k, qp_p), 1e-5)
    check("K3 qvel with per-scenario variable_kp gains", max_err(qv_k, qv_p), 1e-3)
    results["variable_kp_k3_err"] = max(max_err(qp_k, qp_p), max_err(qv_k, qv_p))
    phase_done("variable_kp gains through K3")


# ---- the kernels' tangent rules and the iLQR's AD linearization ---------------------
TANGENT_TOL = 1e-5  # a Function's tangents against torch.func.jvp of its plain version at the same primals,
# relative to each output's largest tangent: the same plain computation, so only the order of float32 sums
# may differ between the two calls
FD_TOL = 2.5e-2     # the AD linearization against forward differences (eps 1e-3), relative to each column's
# largest entry: the ~1e-2 that the forward differences of the contact dynamics move by in float32
# (tests/test_torch_mpc.py: 0.085 of |fx| up to ~300)
AD_B = 32           # the AD MPC ticks' solves (lowered only if the peak memory forced it)
AD_TICKS = 1        # timed ticks of each linearization (2 until the wheeled and legged worlds took their time)


def hold_tangent(label, Fn, launch, plain, counter, args, wrt, gen):
    """Fn (a KernelFunction) at args with random tangents on the operands
    at positions wrt: its primal outputs equal the direct launch's bit for
    bit, its tangents torch.func.jvp of the plain version at the same
    primals (TANGENT_TOL). -> the largest relative tangent error."""
    import torch
    from torch.autograd import forward_ad as fwAD

    direct = launch(*args)
    tans = {i: torch.randn(args[i].shape, generator=gen, device="cuda") for i in wrt}
    passes = counter.tangent_passes
    with fwAD.dual_level():
        outs = Fn.apply(launch, plain, counter, *[fwAD.make_dual(a, tans[i]) if i in tans else a
                                                  for i, a in enumerate(args)])
        got = [fwAD.unpack_dual(o) for o in outs]
    if counter.tangent_passes != passes + 1:
        fail(f"{label}: the Function ran {counter.tangent_passes - passes} tangent passes, not 1")
    for (p, _), d in zip(got, direct):
        if not torch.equal(p, d):
            fail(f"{label}: the Function's primal is not the direct launch's, bit for bit")

    def plain_of(*xs):
        full = list(args)
        for i, x in zip(wrt, xs):
            full[i] = x
        return plain(*full)

    _, ref = torch.func.jvp(plain_of, tuple(args[i] for i in wrt), tuple(tans[i] for i in wrt))
    err = 0.0
    for (_, t), r in zip(got, ref):
        if not bool(torch.isfinite(t).all()):
            fail(f"{label}: non-finite tangents")
        err = max(err, max_err(t, r) / max(1e-6, float(r.abs().max())))
    check(f"{label} tangents vs torch.func.jvp of the plain version (relative)", err, TANGENT_TOL)
    return err


def tangent_checks(tag, world, env, plan, s, n, results):
    """The tangent rules on the card at a world's contact state s (its first
    n scenarios): K1Function, K2Function on the plain path's operands, and,
    where the world is fused, K3Function with and without aux (the aux on
    the planning model `plan`); K4 refuses a dual qpos."""
    import functools

    import torch
    from torch.autograd import forward_ad as fwAD

    from robosuite_tpu_torch.envs.base import map_state
    from robosuite_tpu_torch.ops import contact_solve, fk, forward, substep
    from robosuite_tpu_torch.physics import contact as C
    from robosuite_tpu_torch.physics import engine

    t0 = time.perf_counter()
    model = env.model
    gen = torch.Generator(device="cuda").manual_seed(SEED + 66)
    q, qd = s.physics.qpos[:n].contiguous(), s.physics.qvel[:n].contiguous()
    ctrl = map_state(lambda x: x[:n], s.ctrl)
    errs = results.setdefault("tangent_checks", {})
    errs[f"K1 {world}"] = hold_tangent(
        f"{world} K1Function (B={n})", forward.K1Function, functools.partial(forward._launch, model),
        functools.partial(forward.plain_outputs, model), forward.forward_products,
        (q, qd, *forward.model_leaves(model, n)), (0, 1), gen)
    kin, M, bias = forward.forward_plain(model, q, qd, *forward.model_leaves(model, n))
    c = env.run_controllers(kin, M, bias, q, qd, ctrl)
    qfrc, extra = engine.total_smooth_force(model, q, qd, c, M, bias)
    rows = C.solver_inputs(model, kin, C.narrowphase(model, kin), qd, model.timestep)
    JfT, aref, reg3, mu, act = rows
    k2_args = tuple(t.contiguous() for t in (M, JfT, aref, qfrc, qd, model.dof_damping + extra, reg3, mu, act))
    it = dict(iters=C.solver_iterations(model)[0], power_iters=C.solver_iterations(model)[1], dt=model.timestep)
    errs[f"K2 {world}"] = hold_tangent(
        f"{world} K2Function (B={n}, nv {model.nv}, {act.shape[1]} rows, {int(act.sum(1).max())} active at most)",
        contact_solve.K2Function, functools.partial(contact_solve._launch, **it),
        functools.partial(contact_solve.vel_update_plain, **it), contact_solve.vel_update, k2_args, (0, 1, 2, 3, 4),
        gen)
    if env._fused_for(model) is not None:
        robot = env.robots[0]
        for aux, m in ((False, model), (True, plan)):
            leaves = forward.runtime_leaves(m, n)
            kin_m = forward.forward_plain(m, q, qd, *leaves)[0]
            goal, gains = env._fused_goal_fn(robot, robot.arms[0], ctrl, kin_m)
            args = (q, qd, *leaves, goal, gains, robot.gripper_ctrl(robot.arms[0], ctrl).contiguous())
            plain = substep.substep_aux_plain if aux else substep.substep_plain
            label = "K3-aux" if aux else "K3"
            errs[f"{label} {world}"] = hold_tangent(
                f"{world} K3Function{' (emit_aux, planning model)' if aux else ''} (B={n})", substep.K3Function,
                env._fused_for(m, emit_aux=aux).launch, functools.partial(plain, env, m),
                substep.make_fused_substep, args, (0, 1, 6, 7, 8), gen)
    with fwAD.dual_level():
        try:
            fk.fk_pose(model, fwAD.make_dual(q, torch.ones_like(q)))
            fail(f"{world}: fk_pose took a dual qpos (K4 has no tangent rule)")
        except ValueError as e:
            print(f"{world} K4 on a dual qpos raises: {e}")
    phase_done(f"{world} tangent rules vs torch.func.jvp of the plain versions ({time.perf_counter() - t0:.1f} s)")


def ad_tick_launches(cfg, mpc, env, fused, chunks):
    """Kernel launches of one MPC tick (solve_batch + the executed
    rollout_batch) with one iLQR iteration, relinearized every tick, whose
    linearization is `chunks` calls of the linearization dynamics (1 for
    the forward differences)."""
    H, n_plan = cfg.horizon, mpc.plan_substeps
    n_lin = max(1, int(round(1.0 / (env.control_freq * cfg.fd_timestep)))) if cfg.fd_timestep else n_plan
    if fused:  # MPPI: K1 at the start, K3-aux per planned substep; the executed step: K1 twice, K3 per substep
        k = {"K1": 3, "K2": 0, "K3": env.n_substeps, "K3-aux": H * n_plan, "K4": 0}
    else:      # MPPI: K1 at the start and per planned substep and step end, K2 per substep; the executed step
        k = {"K1": 1 + H * (n_plan + 1) + env.n_substeps + 2, "K2": H * n_plan + env.n_substeps, "K3": 0,
             "K3-aux": 0, "K4": 0}

    def dyn(calls, n_sub):  # one planning-dynamics call: K1, then K3 (fused) or K1 + K2 per substep
        k["K1"] += calls * (1 if fused else 1 + n_sub)
        k["K3" if fused else "K2"] += calls * n_sub

    for _ in range(2):  # the nominal rollout, then the line search over every alpha: H calls each
        dyn(H, n_plan)
        k["K4"] += 2    # their stage costs and terminal cost
    dyn(chunks, n_lin)
    return k


def ad_mpc(tag, name, env, mpc_cfg, batch, results, key, gm, gs):
    """The MPC with one iLQR iteration relinearized every tick by AD
    (ilqr_fd=False, forward mode through the kernels' tangent rules),
    beside the forward-difference one at the same width, both with the
    associative Riccati pass (parallel_backward): a warm-up tick
    and AD_TICKS timed ticks each (solves/s, the launches the config implies,
    the peak device memory, the share of the AD tick in the tangent pass,
    the tangent passes of K1, K2, K3); the AD tick's fx/fu against forward
    differences (eps 1e-3) about the same points on a strided subset:
    each entry between the forward and the backward difference at eps
    (which bracket the derivative, or a kink's one-sided values), within
    FD_TOL of its column's largest entry; a column set aside where
    the central differences at eps and eps / 10 disagree by more than
    FD_TOL (differences that do not converge: a jump within eps, or float32
    rounding amplified by a stiff contact), each set-aside and failing
    column printed; the AD tick's
    associative gains against the sequential pass's (float64) on the same
    inputs, on the (scenario, step) entries whose float32 sequential gains
    agree with the float64 pass's.
    -> (the AD ticks' launch counts, the mpc, its states)."""
    import math

    import torch

    from robosuite_tpu_torch.mpc import ilqr as ilqr_mod
    from robosuite_tpu_torch.mpc import receding
    from robosuite_tpu_torch.ops import contact_solve, forward, substep

    fused = env._fused_for(env.model) is not None
    out = {}
    for mode in ("fd", "ad"):
        cfg = receding.MPCConfig(**dict(mpc_cfg, n_ilqr_iters=1, relin_every=1, ilqr_fd=mode == "fd",
                                        parallel_backward=True))
        mpc = receding.RecedingMPC(env, cfg)
        solve = mpc.make_solve_batch()
        states = valid_resets(env, batch, torch.Generator(device="cuda").manual_seed(gm))[0]
        ms = mpc.init_state(batch, torch.Generator(device="cuda").manual_seed(gs))
        rec, lin_ad, assoc = {"s": 0.0, "calls": 0}, ilqr_mod.linearize_ad, ilqr_mod.backward_associative

        def timed(fn, xs, us, use_jacfwd=True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fx, fu = lin_ad(fn, xs, us, use_jacfwd)
            torch.cuda.synchronize()
            rec["s"] += time.perf_counter() - t0
            rec["calls"] += 1
            rec["last"] = (fn, xs, us, fx, fu)
            return fx, fu

        def recorded(*args):
            rec["backward"] = args
            return assoc(*args)

        ilqr_mod.linearize_ad, ilqr_mod.backward_associative = timed, recorded
        try:
            def tick(st, m):
                acts, m2, met = solve(st, m)
                st2, rew = env.rollout_batch(st, acts)
                return st2, m2, met, acts, rew

            t0 = time.perf_counter()
            states, ms, met, acts, rew = tick(states, ms)
            torch.cuda.synchronize()
            print(f"{tag} {name} MPC ({mode}) warm-up tick s: {time.perf_counter() - t0:.3f}")
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            passes0 = (forward.forward_products.tangent_passes, contact_solve.vel_update.tangent_passes,
                       substep.make_fused_substep.tangent_passes)
            rec["s"], rec["calls"] = 0.0, 0
            t0 = time.perf_counter()
            for i in range(AD_TICKS):
                states, ms, met, acts, rew = tick(states, ms)
                if not (torch.isfinite(acts).all() and acts.abs().max() <= 1.0 and torch.isfinite(rew).all()):
                    fail(f"{name} MPC ({mode}) tick {i + 1}: non-finite or out-of-range actions or rewards")
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            ilqr_mod.linearize_ad, ilqr_mod.backward_associative = lin_ad, assoc
        counts = kcounts()
        passes = (forward.forward_products.tangent_passes - passes0[0],
                  contact_solve.vel_update.tangent_passes - passes0[1],
                  substep.make_fused_substep.tangent_passes - passes0[2])
        take_widths(f"{name} ({mode} MPC)")
        N, P = batch * cfg.horizon, mpc.nx + env.action_dim
        chunks = 1 if mode == "fd" else math.ceil(N / max(1, ilqr_mod.TANGENT_CHUNK // P))
        want = {k: AD_TICKS * v for k, v in ad_tick_launches(cfg, mpc, env, fused, chunks).items()}
        print(f"{name} MPC ({mode}) ticks 1-{AD_TICKS} launches: {counts}; tangent passes (K1, K2, K3) {passes}")
        if counts != want:
            fail(f"{name} MPC ({mode}) ticks 1-{AD_TICKS}: launches {counts}, the config implies {want}")
        if mode == "ad" and (rec["calls"] != AD_TICKS or passes[0] == 0 or passes[1 if not fused else 2] == 0):
            fail(f"{name} AD ticks: {rec['calls']} linearizations, tangent passes {passes}")
        solves, peak = batch * AD_TICKS / dt, torch.cuda.max_memory_allocated() / 1e9
        fin = int(met["ilqr_accepted"].sum())
        share = rec["s"] / dt if mode == "ad" else float("nan")
        print(f"{tag} {name} MPC solves/s ({mode} linearization, B={batch}, H={cfg.horizon}, K={cfg.n_samples}, "
              f"MPPI + 1 iLQR iteration relinearized every tick; ticks 1-{AD_TICKS}, host clock): {solves:.2f}; "
              f"peak device memory {peak:.2f} GB; finite iLQR plans {fin}/{batch}"
              + (f"; the tangent pass {100 * share:.1f}% of the ticks ({rec['s'] / AD_TICKS:.3f} s a tick, {chunks} "
                 f"chunks of at most {ilqr_mod.TANGENT_CHUNK} scenarios)" if mode == "ad" else ""))
        out[mode] = dict(solves_per_s=solves, peak_gb=peak, launches=counts, finite=fin, B=batch)
        if mode == "ad":
            out[mode].update(tangent_share=share, tangent_s=rec["s"] / 2, tangent_passes=passes, chunks=chunks)
            ad = (counts, mpc, rec["last"])
            # the associative pass's gains (the tick's own backward pass) against the sequential pass's on
            # the same linearization and quadratics, at the JAX package's test tolerance
            # (tests/test_mpc.py: rtol 2e-4, atol 2e-5)
            args = rec["backward"]
            names = ("fx", "fu", "cx", "cu", "cxx", "cuu", "cux", "Vx", "Vxx")
            nonfinite = {n: int((~torch.isfinite(a.flatten(1))).any(1).sum()) for n, a in zip(names, args)}
            print(f"{name} AD tick's backward-pass inputs: scenarios with a non-finite entry {nonfinite}")
            ks_a, Ks_a, _, _, _ = assoc(*args)
            ks_s, Ks_s, _ = ilqr_mod.backward_sequential(*args)
            ks_d, Ks_d, _ = ilqr_mod.backward_sequential(*(a.double() for a in args))

            def within(x, y):  # the JAX test's tolerance, per (scenario, step)
                return ((x.double() - y.double()).abs() <= 2e-5 + 2e-4 * y.double().abs()).flatten(2).all(-1)

            # the associative pass (float64 inside) against the sequential pass in float64 on the same inputs,
            # on the entries the float32 inputs determine: where the float32 sequential gains agree with the
            # float64 ones; elsewhere the cost-to-go has outgrown float32 (|fx| ~ 300 over the horizon)
            held = within(Ks_s, Ks_d) & within(ks_s, ks_d)
            viol = max(float(((x.double() - y).abs() - 2e-4 * y.abs())[held].max()) for x, y in ((ks_a, ks_d),
                                                                                              (Ks_a, Ks_d)))
            print(f"{name} associative vs sequential Riccati gains (B={batch}, H={cfg.horizon}, nx {mpc.nx}): held on "
                  f"{int(held.sum())} of {held.numel()} (scenario, step) entries, by step from the horizon's end "
                  f"{held.sum(0).flip(0)[:12].tolist()}...; set aside as ill-conditioned (float32 and float64 "
                  f"sequential gains differ) {int((~held).sum())}; max |a - s| - 2e-4 |s| = {viol:.3e}")
            if not held.any():
                fail(f"{name}: no (scenario, step) of the AD tick has well-conditioned gains to hold")
            check(f"{name} associative gains vs sequential (|a - s| - 2e-4 |s|, well-conditioned entries)", viol,
                  2e-5)

            out[mode].update(assoc_violation=viol, assoc_held=int(held.sum()), assoc_entries=held.numel())
    results[f"{key}_ad_mpc"] = out

    # the AD tick's fx, fu against forward differences about the same points, on a strided subset
    counts, mpc, (fn, xs, us, fx, fu) = ad
    nx, nu = xs.shape[-1], us.shape[-1]
    pts = torch.arange(0, xs.shape[0], 97, device="cuda")
    x, u, eps = xs[pts], us[pts], 1e-3
    eye = torch.eye(nx + nu, device="cuda")

    def differences(h, central):
        def at(sign):
            X = (x[:, None] + sign * h * eye[None, :, :nx]).reshape(-1, nx)
            U = (u[:, None] + sign * h * eye[None, :, nx:]).reshape(-1, nu)
            return fn(X, U).reshape(len(pts), nx + nu, nx)
        lo = at(-1.0) if central else fn(x, u)[:, None]
        return (at(1.0) - lo) / (2 * h if central else h)

    with torch.no_grad():
        fwd, cen, cen2 = differences(eps, False), differences(eps, True), differences(eps / 10, True)
    ad_cols = torch.cat([fx[pts], fu[pts]], dim=-1).transpose(1, 2)            # (n, nx + nu, nx): column p of [fx | fu]
    scale = torch.maximum(ad_cols.abs().amax(-1), fwd.abs().amax(-1)).clamp_min(1e-6)
    # a column whose central differences at eps and eps / 10 disagree has differences that do not converge (a
    # jump within eps, a contact or branch switching, or float32 rounding amplified by a stiff contact over
    # eps / 10: both grow as 1 / eps); elsewhere each AD entry must lie between the forward and the backward
    # difference (which bracket the derivative, or its one-sided values at a kink)
    jump = (cen - cen2).abs().amax(-1) / scale > FD_TOL
    bwd = 2.0 * cen - fwd                                                      # the backward difference
    excess = (torch.minimum(fwd, bwd) - ad_cols).clamp_min(0.0) + (ad_cols - torch.maximum(fwd, bwd)).clamp_min(0.0)
    err = (excess.amax(-1) / scale).masked_fill(jump, 0.0)                    # (n, nx + nu)
    raw = (ad_cols - fwd).abs().amax(-1) / scale
    i, p = divmod(int(err.argmax()), err.shape[1])
    print(f"{name} AD fx/fu vs forward differences on {len(pts)} of {xs.shape[0]} points x {nx + nu} columns: "
          f"median {float(raw.median()):.3e}; outside the forward-backward bracket, max {float(err.max()):.3e} "
          f"(point {int(pts[i])}, column {p}); set aside {int(jump.sum())} of {jump.numel()} columns whose "
          f"differences do not converge")
    for i, p in jump.nonzero().tolist()[:4]:
        print(f"{name} AD vs FD set aside: point {int(pts[i])} column {p}: central differences at eps and eps / 10 "
              f"differ by {float((cen[i, p] - cen2[i, p]).abs().max() / scale[i, p]):.3e} of the column")
    for i, p in (err > FD_TOL).nonzero().tolist()[:8]:
        print(f"{name} AD vs FD witness: point {int(pts[i])} column {p}: AD {ad_cols[i, p].tolist()} forward "
              f"{fwd[i, p].tolist()} central {cen[i, p].tolist()}")
    results[f"{key}_ad_vs_fd"] = dict(median=float(raw.median()), max_beyond_fd_error=float(err.max()),
                                      aside=int(jump.sum()), points=len(pts), columns=nx + nu)
    check(f"{name} AD fx/fu outside the forward-backward difference bracket (relative to each column's largest "
          f"entry)", float(err.max()), FD_TOL)
    return counts, mpc, states


def unbatched_tick(tag, env, mpc_cfg, results):
    """One tick of the one-scenario make_solve on Lift (its full
    relinearization tick) against solve_batch at B=1 on the same state
    and knots: the action, the plan and the RTI carry bit for bit."""
    import torch

    from robosuite_tpu_torch.mpc import mppi, receding

    mpc = receding.RecedingMPC(env, receding.MPCConfig(**mpc_cfg))
    s1 = env.reset_batch(1, torch.Generator(device="cuda").manual_seed(SEED + 23))[0]
    knots = torch.randn((1,) + mppi.noise_shape(mppi.MPPIConfig(horizon=mpc.cfg.horizon, n_samples=mpc.cfg.n_samples,
                                                                n_knots=mpc.cfg.n_knots), env.action_dim),
                        generator=torch.Generator(device="cuda").manual_seed(SEED + 24), device="cuda")
    zero_counts()
    a, ms, met = mpc.make_solve()(mppi.drop_batch(s1), mpc.init_state(None, None), knots=knots[0])
    counts = kcounts()
    a1, ms1, _ = mpc.make_solve_batch()(s1, mpc.init_state(1, None), knots=knots)
    torch.cuda.synchronize()
    same = (torch.equal(a, a1[0]) and torch.equal(ms.us, ms1.us[0]) and torch.equal(ms.fxs, ms1.fxs[0])
            and torch.equal(ms.fus, ms1.fus[0]))
    print(f"{tag} Lift make_solve (one scenario, no batch dim; launches {counts}): action {a.tolist()}; equal to "
          f"solve_batch at B=1 bit for bit: {same}; finite iLQR plan {bool(met['ilqr_accepted'])}")
    if a.shape != (env.action_dim,) or ms.fxs.shape != (mpc.cfg.horizon, mpc.nx, mpc.nx) or not same:
        fail("the one-scenario make_solve is not solve_batch at B=1")
    results["lift_make_solve_launches"] = counts
    return counts


# ---- the remaining arm controllers (phases 71-80) -------------------------------------
LINEAR = {"right": {"type": "OSC_POSE", "interpolation": "linear"}}
ABS_WORLD = {"right": {"type": "OSC_POSE", "input_type": "absolute", "input_ref_frame": "world"}}
# the shorter holds (phases 76-80): name -> (env, make's keywords, fused, absolute world-frame actions)
CTRL_HELD = {
    "Lift OSC_POSE linear": ("Lift", dict(robots="Panda", controller_configs=LINEAR), True, False),
    "Door OSC_POSE absolute world": ("Door", dict(robots="Panda", controller_configs=ABS_WORLD, seed=0), True, True),
    "Lift JOINT_VELOCITY": ("Lift", dict(robots="Panda", controller_configs="JOINT_VELOCITY"), False, False),
    "Lift JOINT_TORQUE": ("Lift", dict(robots="Panda", controller_configs="JOINT_TORQUE"), False, False),
    "Sawyer-Lift IK_POSE": ("Lift", dict(robots="Sawyer", controller_configs="IK_POSE"), False, False),
}


def ctrl_env(name, env_name, kw, fused):
    """make(env_name, **kw) on CUDA, its fused gate deciding as the JAX
    gate does: `fused` (an OSC arm on a world of static rows), or
    UnsupportedFused. -> the env."""
    import copy

    import robosuite_tpu_torch as R
    from robosuite_tpu_torch.ops import substep

    env = R.make(env_name, reward_shaping=True, **copy.deepcopy(kw))
    try:
        spec = substep.extract_spec(env, env.model)
        why = f"fused ({spec['ctrl_type']} law)"
    except substep.UnsupportedFused as e:
        spec, why = None, f"UnsupportedFused({e})"
    cfg = env.robots[0].arm_cfg["right"]
    print(f"{name}: {type(cfg).__name__}, action_dim {env.action_dim}, nq {env.model.nq}, nv {env.model.nv}; "
          f"the fused gate: {why}")
    if (spec is not None) != fused or (env._fused_for(env.model) is not None) != fused:
        fail(f"the fused gate does not decide {name} as the JAX gate does ({'fused' if fused else 'unfused'})")
    return env


def ctrl_actions(env, states, gen, absolute=False):
    """Small random deltas (B, A), the gripper's too; with `absolute`, OSC
    goals in the world frame near the eef: its position plus up to 2 cm,
    its orientation's axis-angle plus up to 0.05 rad; clipped to the
    action spec ([-1, 1]), as the env clips them."""
    import torch

    from robosuite_tpu_torch.physics import engine
    from robosuite_tpu_torch.utils import transforms as T

    a = torch.clamp(0.3 * torch.randn(B, env.action_dim, generator=gen, device="cuda"), -1.0, 1.0)
    if absolute:
        kin = engine.forward_products(env.model, states.physics.qpos, states.physics.qvel)[0]
        site = env.robots[0].eef_site_id["right"]
        noise = 2.0 * torch.rand(B, 6, generator=gen, device="cuda") - 1.0
        a[:, :3] = kin.site_xpos[:, site] + 0.02 * noise[:, :3]
        a[:, 3:6] = T.quat2axisangle(T.mat2quat(kin.site_xmat[:, site])) + 0.05 * noise[:, 3:]
    return env._clip(a)


def fused_step_slice(tag, name, env, gen, results, key, actions, steps, held=None, rollout=False):
    """A fused world's step slice: counts zeroed, reset_batch + `steps`
    step_batch (with `rollout`, rollout_batch) policy steps at B (K1 = 2 a
    step + 1, K3 = 25 a step), finite observations and rewards, done only
    at the horizon, the rate with the reset; then each policy step (the
    first `held`, all by default) from the same input against the plain
    path, substep by substep (the goal rows of each substep, the kernel
    and the plain substep) under hold_all's rule, with
    pose_rounding_witness's float64 witness where the goal row does not
    move within the step (a box face resting flat on the table: the
    float32 solve's forces part ways while the velocities agree), the kernel's last
    substep being the step's next state bit for bit; the reward on the
    plain poses; how far the goal row moves within a step (goal
    interpolation). -> (the launch counts, the trail of states)."""
    import torch

    from robosuite_tpu_torch.ops import forward, substep
    from robosuite_tpu_torch.physics import engine

    model, robot = env.model, env.robots[0]
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states, obs0 = env.reset_batch(B, gen)
    trail, rewards, obs_all = [states], [], []
    for _ in range(steps):
        if rollout:
            states, r = env.rollout_batch(states, actions)
        else:
            states, obs, r, done, _ = env.step_batch(states, actions)
            obs_all.append(obs)
            if bool(done.any()):
                fail(f"{name} step_batch: done before the horizon")
        trail.append(states)
        rewards.append(r)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kcounts()
    take_widths(name.split()[0])
    print(f"{name} main path launches over reset + {steps} {'rollout_batch' if rollout else 'step_batch'} policy "
          f"steps: {counts}")
    if counts != {"K1": 2 * steps + 1, "K2": 0, "K3": env.n_substeps * steps, "K3-aux": 0, "K4": 0}:
        fail(f"unexpected {name} launch counts {counts}")
    rew = torch.stack(rewards)
    if not (all(torch.isfinite(v.float()).all() for o in obs_all for v in o.values()) and torch.isfinite(rew).all()):
        fail(f"non-finite observations or rewards on the {name} path")
    print(f"{tag} {name} env policy-steps/s (B={B}, host clock): {B * steps / dt:.1f} with the reset (reset + "
          f"{steps} steps); rewards mean {float(rew.mean()):.4f} max {float(rew.max()):.4f}")
    results.update({f"{key}_policy_steps_per_s_with_reset": B * steps / dt, f"{key}_launches": counts})
    fused, leaves = env._fused_for(model), forward.runtime_leaves(model, B)
    worst, worst_r, moved, before = 0.0, 0.0, 0.0, len(ASIDE)
    held = steps if held is None else held
    # the float64 witness redoes the controllers at the policy step's goal,
    # which an interpolated goal row leaves within the step
    interpolated = getattr(robot.arm_cfg["right"], "interpolation", None) == "linear"
    for i in range(held):
        st, nxt = trail[i], trail[i + 1]
        kin, M, bias = engine.forward_products(model, st.physics.qpos, st.physics.qvel)
        ctrl_i = env._set_goals(kin, M, bias, st.physics.qpos, st.physics.qvel, st.ctrl, actions)
        goal_at = env._fused_goals(robot, "right", ctrl_i, kin)
        grip = robot.gripper_ctrl("right", ctrl_i).contiguous()
        moved = max(moved, max_err(goal_at(0)[0], goal_at(env.n_substeps - 1)[0]))
        qp, qv = st.physics.qpos, st.physics.qvel
        for j in range(env.n_substeps):
            sub = (qp, qv, *leaves, *goal_at(j), grip)
            out_k, out_p = fused(*sub), substep.substep_plain(env, model, *sub)
            ph = engine.State(qpos=qp, qvel=qv, time=st.physics.time + j * model.timestep)
            worst = max(worst, hold_all(
                f"{name} step {i + 1} substep {j + 1}", model, qp, out_k, out_p, quiet=True,
                extra=None if interpolated else lambda bad, p=ph, k=out_k, q=out_p: pose_rounding_witness(
                    env, model, ctrl_i, p, bad, k, q)))
            qp, qv = out_k[0], out_k[1]
        if not (torch.equal(qp, nxt.physics.qpos) and torch.equal(qv, nxt.physics.qvel)):
            fail(f"{name} policy step {i + 1}: step_batch differs from its substep-by-substep kernel run")
        kin_p = forward.forward_plain(model, qp, qv, *leaves)[0]
        worst_r = max(worst_r, max_err(rewards[i], env.reward(nxt.physics, kin_p)))
    torch.cuda.synchronize()
    print(f"{name} the first {held} of {steps} policy steps against the plain path from the same input, substep by "
          f"substep: largest qpos / qvel error held {worst:.3e}; the goal row moves {moved:.3e} within a step; "
          f"{len(ASIDE) - before} (substep, scenario) cases set aside on a float64 witness")
    check(f"{name} {held} policy steps: reward (kernel path vs plain path)", worst_r, 1e-4)
    results.update({f"{key}_set_aside": len(ASIDE) - before, f"{key}_goal_moves": moved})
    return counts, trail


def fused_mppi_tick(tag, name, env, results, key, seed):
    """One MPPI tick of a fused world at tools/bench_configs.py's width
    (B=32, H=64, K=16): a warm-up tick, then one timed tick with the
    launches the config implies (K3-aux per planned substep), finite
    actions in [-1, 1]. -> the launch counts."""
    import torch

    from robosuite_tpu_torch.mpc import receding

    cfg = receding.MPCConfig(**H64_MPC)
    mpc = receding.RecedingMPC(env, cfg)
    solve = mpc.make_solve_batch()
    states = env.reset_batch(H64_B, torch.Generator(device="cuda").manual_seed(seed))[0]
    ms = mpc.init_state(H64_B, torch.Generator(device="cuda").manual_seed(seed + 1))

    def tick(st, m):
        acts, m2, _ = solve(st, m)
        st2, rew = env.rollout_batch(st, acts)
        return st2, m2, acts, rew

    t0 = time.perf_counter()
    states, ms, _, _ = tick(states, ms)
    torch.cuda.synchronize()
    print(f"{tag} {name} MPC warm-up tick s: {time.perf_counter() - t0:.3f}")
    zero_counts()
    t0 = time.perf_counter()
    states, ms, acts, rew = tick(states, ms)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kcounts()
    take_widths(name.split()[0])
    want = tick_launches(cfg, mpc, env, False)
    print(f"{name} MPC tick launches: {counts}")
    if counts != want:
        fail(f"{name} MPC tick: launches {counts}, the config implies {want}")
    if not (torch.isfinite(acts).all() and acts.abs().max() <= 1.0 and torch.isfinite(rew).all()):
        fail(f"{name} MPC tick: non-finite or out-of-range actions, or non-finite rewards")
    print(f"{tag} {name} MPC solves/s (B={H64_B}, H={cfg.horizon}, K={cfg.n_samples}, MPPI only; one tick, host "
          f"clock): {H64_B / dt:.2f}")
    results.update({f"{key}_mpc_solves_per_s": H64_B / dt, f"{key}_mpc_launches": counts})
    return counts


def fd_ilqr_tick(tag, name, env, results, key, seed):
    """One MPC tick with MPPI and one iLQR iteration linearized by forward
    differences (relinearized every tick, linearization dt 50 ms) at
    B=32, H=64, K=16: a warm-up tick, one timed tick with the launches the
    config implies, finite actions in [-1, 1], the finite iLQR plans and
    the peak memory (the profiled tick cut for the run's time in PR 15).
    -> the launch counts of the timed tick."""
    import torch

    from robosuite_tpu_torch.mpc import receding

    cfg = receding.MPCConfig(**dict(H64_MPC, n_ilqr_iters=1, relin_every=1, fd_timestep=0.05))
    mpc = receding.RecedingMPC(env, cfg)
    solve = mpc.make_solve_batch()
    states = valid_resets(env, H64_B, torch.Generator(device="cuda").manual_seed(seed))[0]
    ms = mpc.init_state(H64_B, torch.Generator(device="cuda").manual_seed(seed + 1))

    def tick(st, m):
        acts, m2, met = solve(st, m)
        st2, rew = env.rollout_batch(st, acts)
        return st2, m2, met, acts, rew

    t0 = time.perf_counter()
    states, ms, *_ = tick(states, ms)
    torch.cuda.synchronize()
    print(f"{tag} {name} MPC (FD iLQR) warm-up tick s: {time.perf_counter() - t0:.3f}")
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    states, ms, met, acts, rew = tick(states, ms)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kcounts()
    take_widths(f"{name} (fd MPC)")
    want = ad_tick_launches(cfg, mpc, env, env._fused_for(env.model) is not None, 1)
    print(f"{name} MPC (FD iLQR) tick launches: {counts}")
    if counts != want:
        fail(f"{name} MPC (FD iLQR) tick: launches {counts}, the config implies {want}")
    if not (torch.isfinite(acts).all() and acts.abs().max() <= 1.0 and torch.isfinite(rew).all()):
        fail(f"{name} MPC (FD iLQR) tick: non-finite or out-of-range actions, or non-finite rewards")
    peak, fin = torch.cuda.max_memory_allocated() / 1e9, int(met["ilqr_accepted"].sum())
    print(f"{tag} {name} MPC solves/s (B={H64_B}, H={cfg.horizon}, K={cfg.n_samples}, MPPI + 1 iLQR iteration "
          f"linearized by forward differences, {H64_B * cfg.horizon * (1 + mpc.nx + env.action_dim)} scenarios "
          f"in the sweep; one tick, host clock): {H64_B / dt:.2f}; finite iLQR plans {fin}/{H64_B}; iLQR improved "
          f"on MPPI {int(met['ilqr_improved'].sum())}; peak device memory {peak:.2f} GB")
    results.update({f"{key}_ilqr_solves_per_s": H64_B / dt, f"{key}_ilqr_launches": counts,
                    f"{key}_ilqr_peak_gb": peak, f"{key}_ilqr_finite": fin})
    return counts


def controllers_slice(tag, results):
    """Phases 71-80, the remaining arm controllers. 71-74: Lift-Panda with
    IK_POSE, the headline path, unfused (K1, the 66 static contact rows as
    one CUDA graph, K2; the gate refuses the IK arm as the JAX gate does):
    71, the world, K1 at B=512 and 32 against its plain version and timed;
    72, counts zeroed, reset + 10 step_batch policy steps, the first
    EARLIER_HELD held substep by substep (cut from all 10, and the steady
    rate and the profiled step cut, for the run's time); 73, K2 at nv
    15 and 66 static rows on the plain path's operands at the step's last
    state (the cube resting on the table), against its plain version,
    timed; 74, one MPPI tick (B=32, H=64, K=16) and one tick with an iLQR
    iteration linearized by forward differences.
    75: Lift-Panda OSC_POSITION, fused (K3; the orientation goal frozen at
    the eef's): reset + 10 step_batch steps, each held substep by substep
    against the plain path under hold_all's rule, 10 steady steps, one
    MPPI tick through K3-aux. 76-80, the
    shorter holds (CTRL_HELD), reset + EARLIER_HELD step_batch steps held
    substep by substep, no steady rate: Lift OSC_POSE with linear goal
    interpolation (fused, a goal row a substep), Door OSC_POSE with
    absolute world-frame goals (fused), Lift JOINT_VELOCITY and
    JOINT_TORQUE (unfused), Sawyer-Lift IK_POSE (unfused, its rows
    compacted into 96 slots). -> {path: launch counts}."""
    import torch

    from robosuite_tpu_torch.physics import contact as C

    out = {}
    # ---- 71. Lift-Panda IK_POSE: the world, the gate, K1
    name = "Lift IK_POSE"
    env = ctrl_env(name, "Lift", dict(robots="Panda", controller_configs="IK_POSE"), False)
    model = env.model
    nrows = sum(len(r) for r in C.contact_row_layout(model).values())
    if C.uses_row_compaction(model) or nrows != 66 or env.action_dim != 7:
        fail(f"{name}: {nrows} rows (compacted {C.uses_row_compaction(model)}), action_dim {env.action_dim}")
    world_k = results.setdefault("unfused_kernels", {}).setdefault(name, {})
    gen = torch.Generator(device="cuda").manual_seed(SEED + 71)
    states = env.reset_batch(B, gen)[0]
    unfused_k1(tag, name, model, states, (B, H64_B), world_k, results)
    phase_done(f"{name} world, gate, K1")
    # ---- 72. the step slice, every substep held
    actions = ctrl_actions(env, states, gen)
    out[f"{name} step"], last, _ = unfused_step_slice(tag, name, env, gen, results, "lift_ik", actions, False,
                                                      held=EARLIER_HELD)
    # ---- 73. K2 at the 66 static rows, at the step's last state
    from robosuite_tpu_torch.ops import forward

    q, qd = last.physics.qpos, last.physics.qvel
    kin, M, bias = forward.forward_plain(model, q, qd, *forward.runtime_leaves(model, B))
    con = C.narrowphase(model, kin)
    n_act = (con["dist"] < con["margin"]).sum(1)
    print(f"{name} K2 state (the last step's): active rows per scenario min {int(n_act.min())} median "
          f"{int(n_act.median())} max {int(n_act.max())} of {nrows}")
    if 2 * int((n_act >= 4).sum()) < B:
        fail(f"{name}: fewer than 4 active rows in half the scenarios at the K2 state")
    unfused_k2(name, env, states, last, kin, M, bias, con, nrows, world_k)
    # ---- 74. the MPC: an MPPI tick, then a tick with an FD-linearized iLQR iteration
    out[f"{name} MPC"] = unfused_mpc(tag, name, env, H64_MPC, H64_B, 1,
                                     torch.Generator(device="cuda").manual_seed(SEED + 72),
                                     torch.Generator(device="cuda").manual_seed(SEED + 73), results, "lift_ik",
                                     (states, last), world_k, False)
    out[f"{name} iLQR"] = fd_ilqr_tick(tag, name, env, results, "lift_ik", SEED + 74)
    phase_done(f"{name} MPC ticks (MPPI, FD iLQR)")
    del env

    # ---- 75. Lift-Panda OSC_POSITION, fused: the step held whole, the steady rate, an MPPI tick through K3-aux
    name = "Lift OSC_POSITION"
    env = ctrl_env(name, "Lift", dict(robots="Panda", controller_configs="OSC_POSITION"), True)
    if env.action_dim != 4:
        fail(f"{name}: action_dim {env.action_dim}, not 4")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 75)
    actions = ctrl_actions(env, None, gen)
    out[f"{name} step"], trail = fused_step_slice(tag, name, env, gen, results, "lift_osc_position", actions, STEPS)
    # the orientation goal: the eef's orientation in the base frame at the start of the step that set it
    from robosuite_tpu_torch.controllers.parts import osc
    from robosuite_tpu_torch.physics import engine

    st = trail[-2].physics
    kin, M, bias = engine.forward_products(env.model, st.qpos, st.qvel)
    view = env.robots[0].arm_view(kin, M, bias, st.qpos, st.qvel, "right")
    check(f"{name} orientation goal held at the eef's", max_err(trail[-1].ctrl.arm["right"].goal_ori,
                                                                 osc._eef_pose(env.robots[0].arm_cfg["right"], view)[1]),
          1e-6)
    t0, s_ss = time.perf_counter(), trail[-1]
    for _ in range(STEPS):
        s_ss = env.step_batch(s_ss, actions)[0]
    torch.cuda.synchronize()
    steady = B * STEPS / (time.perf_counter() - t0)
    print(f"{tag} {name} env policy-steps/s (B={B}, host clock): {steady:.1f} steady ({STEPS} step_batch steps "
          f"after the run)")
    results["lift_osc_position_policy_steps_per_s"] = steady
    out[f"{name} MPC"] = fused_mppi_tick(tag, name, env, results, "lift_osc_position", SEED + 76)
    phase_done(f"{name} step slice and MPPI tick")
    del env

    out.update(ctrl_held_slice(tag, results))
    return out


def ctrl_held_slice(tag, results):
    """Phases 76-80, the shorter holds of CTRL_HELD (controllers_slice).
    -> {path: launch counts}."""
    import torch

    out = {}
    for i, (name, (env_name, kw, fused, absolute)) in enumerate(CTRL_HELD.items()):
        env = ctrl_env(name, env_name, kw, fused)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 77 + i)
        key = name.lower().replace(" ", "_").replace("-", "_")
        if fused:
            reset = env.reset_batch(B, torch.Generator(device="cuda").manual_seed(SEED + 77 + i))[0]
            actions = ctrl_actions(env, reset, gen, absolute)
            out[name], _ = fused_step_slice(tag, name, env, gen, results, key, actions, EARLIER_HELD)
            moves = results[f"{key}_goal_moves"]
            interp = env.robots[0].arm_cfg["right"].interpolation == "linear"
            if interp != (moves > 0.0):
                fail(f"{name}: the goal row moves {moves:.3e} within a step (interpolation {interp})")
        else:
            actions = ctrl_actions(env, None, gen)
            out[name] = unfused_step_slice(tag, name, env, gen, results, key, actions, False, EARLIER_HELD)[0]
        phase_done(f"{name} reset + {EARLIER_HELD} steps held substep by substep")
        del env
    return out


# ---- phases 81-92: the robots that need no new physics (SpotArm, PandaDexRH / LH, Baxter)
DEX_MPC = dict(horizon=64, n_samples=32, noise_sigma=0.4, temperature=0.2, n_knots=8, n_ilqr_iters=1,
               plan_timestep=0.025, relin_every=1, fd_timestep=0.05, plan_pair_points=2)  # bench.py's Lift shape
DEX_MB = 128


def hold_fused_launch(tag, label, env, model, s, emit_aux, results, key):
    """One K3 (or K3-aux) launch on `model` at the state s (its batch)
    against its plain version: qpos 1e-5, qvel 1e-3 and, for K3, f 1e-4 of
    its largest under hold_all's rule; for K3-aux the post-step poses
    (2e-5) and pair distances (hold_pair_dist) against the plain version at
    the kernel's own post-step qpos, as phases 14 and 20 hold them; timed
    (events, device, the plain version, the bound at this state's active
    rows) into results["robot_kernels"][key]. -> the largest error held."""
    import torch

    from robosuite_tpu_torch.ops import forward, substep
    from robosuite_tpu_torch.physics import contact as C

    q, qd = s.physics.qpos.contiguous(), s.physics.qvel.contiguous()
    n = q.shape[0]
    fused = env._fused_for(model, emit_aux=emit_aux)
    plain = substep.substep_aux_plain if emit_aux else substep.substep_plain
    leaves = forward.runtime_leaves(model, n)
    kin = forward.forward_plain(model, q, qd, *leaves)[0]
    robot = env.robots[0]
    goal, gains = env._fused_goal_fn(robot, "right", s.ctrl, kin)
    args = (q, qd, *leaves, goal, gains, robot.gripper_ctrl("right", s.ctrl).contiguous())
    act = C.solver_inputs(model, kin, C.narrowphase(model, kin), qd, model.timestep)[-1].sum(1)
    out_k, out_p = fused(*args), plain(env, model, *args)
    torch.cuda.synchronize()
    nrows = sum(len(r) for r in C.contact_row_layout(model).values())
    print(f"{label} (B={n}): active rows per scenario min {int(act.min())} median {int(act.median())} max "
          f"{int(act.max())} of {nrows}; {len(robot.gripper_actuator_ids['right'])} gripper actuators, "
          f"{len(robot.arm_qvel_idx['right'])} arm dofs")
    n_out = 2 if emit_aux else 3
    err = hold_all(label, model, q, out_k[:n_out], out_p[:n_out])
    if emit_aux:
        kin2 = forward.forward_plain(model, out_k[0], out_k[1], *leaves)[0]
        for name, a, b in zip(("site_xpos", "site_xmat", "xpos"), out_k[3:6],
                              (kin2.site_xpos, kin2.site_xmat, kin2.xpos)):
            check(f"{label} {name} (the plain poses at the kernel's post-step qpos)", max_err(a, b), 2e-5)
            err = max(err, max_err(a, b))
        pd = C.pair_min_dists(model, kin2)
        err = max(err, hold_pair_dist(label, model, out_k[-1], pd, out_k[0], out_k[0]))
    flops = op_counts(model, nrows, float(act.float().mean()), iters=model.solver_iters or C.APGD_ITERS,
                      na=len(robot.arm_qvel_idx["right"]))["K3-aux" if emit_aux else "K3"]
    r = dict(max_abs_err=err, batch=n, ms=cuda_ms(lambda: fused(*args), 10),
             dev_ms=device_ms(lambda: fused(*args), 10), plain_ms=cuda_ms(lambda: plain(env, model, *args), 2),
             bound=bound(nbytes(*args, *out_k), flops, n))
    print(f"{tag} {label} (B={n}): {r['ms']:.4f} ms by events, {r['dev_ms']:.4f} ms device, plain "
          f"{r['plain_ms']:.3f} ms, bound {r['bound'][0]:.5f} ms ({r['bound'][1]})")
    results.setdefault("robot_kernels", {})[key] = r
    return err


def fused_carve(tag, name, env, model, results):
    """K3's and K3-aux's shared memory a scenario and scenarios resident an
    SM at this world's carve, against the card's opt-in limit a block."""
    import torch

    from robosuite_tpu_torch.ops import substep

    optin = getattr(torch.cuda.get_device_properties(0), "shared_memory_per_block_optin", 232448)
    out = {}
    for aux, m in ((False, model), (True, model.replace(timestep=0.025, solver_iters=10, pair_points_cap=2))):
        fused = env._fused_for(m, emit_aux=aux)
        smem, res = substep.smem_bytes(fused), substep.resident_per_sm(fused)
        out["K3-aux" if aux else "K3"] = (smem, res)
        print(f"{name} {'K3-aux (planning model)' if aux else 'K3'}: rs_substep_smem_bytes {smem} B a scenario, "
              f"rs_substep_resident {res} scenarios an SM; the card's opt-in limit {optin} B a block")
        if not 0 < smem <= optin or res < 1:
            fail(f"{name}: the fused substep's carve ({smem} B) does not fit the card")
    results.setdefault("robot_carves", {})[name] = out


def fused_world(name, env_name, robot, fused=True, **kw):
    """make(env_name, robots=robot) on CUDA, its sizes printed, the fused
    gate deciding as the JAX gate does. -> the env."""
    from robosuite_tpu_torch.physics import contact as C

    env = ctrl_env(name, env_name, dict(robots=robot, **kw), fused)
    m = env.model
    rows = sum(len(r) for r in C.contact_row_layout(m).values())
    print(f"{name} world: nq={m.nq} nv={m.nv} nbody={m.nbody} ngeom={m.ngeom} nsite={m.nsite} nu={m.nu} "
          f"npair={m.npair} rows={rows} (compacted {C.uses_row_compaction(m)}); gripper actuators "
          f"{[len(r.gripper_actuator_ids[a]) for r in env.robots for a in r.arms]}")
    return env


def dex_mpc_tick(tag, name, env, results, key, seed):
    """Lift-PandaDexRH's MPC at bench.py's Lift shape (B=128, H=64, K=32,
    MPPI + one iLQR iteration linearized by forward differences, every
    tick): a warm-up tick, one timed tick with the launches the config
    implies, finite actions in [-1, 1]; the sweep's width; then K3-aux at
    the MPPI width B*K against its plain version, K4 at the iLQR costs'
    widths (B, B*H) against its plain version, and K1 at the sweep's width
    against its plain version on strided rows, timed. -> the tick's
    launch counts."""
    import torch

    from robosuite_tpu_torch.envs.base import map_state
    from robosuite_tpu_torch.mpc import receding
    from robosuite_tpu_torch.ops import fk, forward

    cfg = receding.MPCConfig(**DEX_MPC)
    mpc = receding.RecedingMPC(env, cfg)
    solve = mpc.make_solve_batch()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    states = env.reset_batch(DEX_MB, gen)[0]
    ms = mpc.init_state(DEX_MB, torch.Generator(device="cuda").manual_seed(seed + 1))

    def tick(st, m):
        acts, m2, met = solve(st, m)
        st2, rew = env.rollout_batch(st, acts)
        return st2, m2, met, acts, rew

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    states, ms, *_ = tick(states, ms)
    torch.cuda.synchronize()
    print(f"{tag} {name} MPC warm-up tick s: {time.perf_counter() - t0:.3f}")
    zero_counts()
    t0 = time.perf_counter()
    states, ms, met, acts, rew = tick(states, ms)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kcounts()
    take_widths(name)
    want = tick_launches(cfg, mpc, env, True)
    N = DEX_MB * cfg.horizon * (1 + mpc.nx + env.action_dim)
    print(f"{name} MPC tick launches: {counts}; the forward-difference sweep: {N} scenarios (nx {mpc.nx}, "
          f"{env.action_dim} actions)")
    if counts != want:
        fail(f"{name} MPC tick: launches {counts}, the config implies {want}")
    if not (torch.isfinite(acts).all() and acts.abs().max() <= 1.0 and torch.isfinite(rew).all()):
        fail(f"{name} MPC tick: non-finite or out-of-range actions, or non-finite rewards")
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"{tag} {name} MPC solves/s (B={DEX_MB}, H={cfg.horizon}, K={cfg.n_samples}, MPPI + 1 iLQR iteration "
          f"linearized by forward differences every tick; one tick, host clock): {DEX_MB / dt:.2f}; finite iLQR "
          f"plans {int(met['ilqr_accepted'].sum())}/{DEX_MB}; peak device memory {peak:.2f} GB")
    results.update({f"{key}_mpc_solves_per_s": DEX_MB / dt, f"{key}_mpc_launches": counts,
                    f"{key}_mpc_peak_gb": peak, f"{key}_fd_sweep": N})
    # K3-aux at the MPPI width B*K on the planning model, from the tick's states (each copy after the first
    # with its own small arm velocity)
    plan = mpc.plan_model
    BK = DEX_MB * cfg.n_samples
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    wide = map_state(lambda x: x.repeat((cfg.n_samples,) + (1,) * (x.dim() - 1)), states)
    qd = wide.physics.qvel.clone()
    qd[DEX_MB:, :7] += 0.05 * torch.randn(BK - DEX_MB, 7, generator=g, device="cuda")
    wide.physics.qvel = qd
    hold_fused_launch(tag, f"{name} K3-aux (planning model)", env, plan, wide, True, results, f"{key} K3-aux")
    # K4 at the iLQR costs' widths
    q = states.physics.qpos
    for n in (DEX_MB, DEX_MB * cfg.horizon):
        qq = q.repeat(n // DEX_MB, 1)
        qq[:, :7] += 0.3 * torch.randn(n, 7, generator=g, device="cuda")
        xp_k, xq_k = fk.fk_pose(plan, qq)
        xp_p, xq_p = fk.fk_pose_plain(plan, qq)
        torch.cuda.synchronize()
        check(f"{name} K4 xpos (B={n})", max_err(xp_k, xp_p), 2e-5)
        check(f"{name} K4 xquat (B={n})", max_err(xq_k, xq_p), 2e-5)
    # K1 at the sweep's width on states like the sweep's (the tick's, each with its own arm pose and velocity)
    release_memory(f"{name} K1 at B={N}")
    reps = N // DEX_MB
    qx = q.repeat(reps, 1)
    qx[:, :7] += 0.3 * torch.randn(N, 7, generator=g, device="cuda")
    qvx = 0.2 * torch.randn(N, env.model.nv, generator=g, device="cuda")
    lin = mpc.lin_model
    rows = torch.cat([torch.arange(0, N, 257, device="cuda"), torch.tensor([N - 1], device="cuda")])
    kin_k, M_k, bias_k = forward.forward_products(lin, qx, qvx)
    kin_k = {f: v[rows] for f, v in kin_k.__dict__.items() if v is not None}
    M_k, bias_k = M_k[rows], bias_k[rows]
    torch.cuda.empty_cache()
    kin_p, M_p, bias_p = forward.forward_plain(lin, qx[rows], qvx[rows], *forward.model_leaves(lin, rows.numel()))
    check(f"{name} K1 poses (B={N}, {rows.numel()} strided rows)",
          max(max_err(v, getattr(kin_p, f)) for f, v in kin_k.items()), 2e-5)
    check(f"{name} K1 M (relative, B={N})", max_err(M_k, M_p) / max(1.0, float(M_p.abs().max())), 1e-5)
    check(f"{name} K1 bias (relative, B={N})", max_err(bias_k, bias_p) / max(1.0, float(bias_p.abs().max())), 1e-4)
    del kin_k, M_k, bias_k, kin_p, M_p, bias_p
    results["k1_widths"].append(dict(world=name, **time_width(
        tag, f"K1 {name}", lambda: forward.forward_products(lin, qx, qvx),
        lambda: forward.forward_plain(lin, qx, qvx, *forward.model_leaves(lin, N)), 5, k1_bytes(lin, N),
        op_counts(lin, 0)["K1"], N)))
    del qx, qvx
    torch.cuda.empty_cache()
    return counts


def dex_contact_state(env, states, name):
    """A state in contact for the PandaDex worlds, whose hands (meshes with
    no hull) touch nothing: Stack, cubeA dropped onto cubeB in every other
    scenario and four zero-action steps to land (the others' cubes on the
    table); Door, the reset (the latch against the frame)."""
    import torch

    if not name.startswith("Stack"):
        return states
    m = env.model
    qa = m.jnt_qposadr[m.body_jntadr[env.cubeA_body_id]]
    qb = m.jnt_qposadr[m.body_jntadr[env.cubeB_body_id]]
    qpos = states.physics.qpos.clone()
    qpos[::2, qa:qa + 3] = qpos[::2, qb:qb + 3] + torch.tensor([0.0, 0.0, 0.025 + 0.02 + 0.002], device="cuda")
    s = env.state_from_flattened(torch.cat([states.physics.time[:, None], qpos, states.physics.qvel], 1).cpu())
    zero = torch.zeros(B, env.action_dim, device="cuda")
    for _ in range(4):
        s, _ = env.rollout_batch(s, zero)
    stacked = int((s.physics.qpos[:, qa + 2] > s.physics.qpos[:, qb + 2] + 0.03).sum())
    print(f"{name} contact state: cubeA resting on cubeB in {stacked}/{B} scenarios")
    if stacked < B // 4:
        fail(f"the {name} contact state has too few stacked scenarios")
    return s


def rows_graph_report(tag, name, model, kin, qvel, results):
    """The unfused substep's contact rows graph (physics/contact._RowsGraph)
    for this world at this batch: the capture's time (a fresh graph: two
    eager warm-up runs and the capture), its replay's time by events, and
    the device activities in one eager run of the captured code and in one
    replay (the profiler), and the device memory the capture reserved."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from robosuite_tpu_torch.physics import contact as C

    dt = model.timestep
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    graph = C._RowsGraph(model, kin, qvel, dt)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    graph_gb = (torch.cuda.memory_reserved() - reserved) / 1e9
    replay_ms = cuda_ms(lambda: graph(kin, qvel), 5)
    counts = []
    for fn in (lambda: C.solver_inputs(model, kin, C.narrowphase(model, kin), qvel, dt), lambda: graph(kin, qvel)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts.append(sum(r[2] for r in kernel_rows(prof)))
    print(f"{tag} {name} contact rows graph (B={qvel.shape[0]}, {model.npair} pairs): capture {capture_s:.2f} s, "
          f"{graph_gb:.3f} GB reserved; replay {replay_ms:.3f} ms by events; device activities {counts[0]} in one "
          f"eager run, {counts[1]} recorded in one replay")
    results.setdefault("rows_graphs", {})[name] = dict(capture_s=capture_s, replay_ms=replay_ms, graph_gb=graph_gb,
                                                       eager_kernels=counts[0], replay_kernels=counts[1])


def _lift_grasped(env, kin, n_act):
    grasp, rich = int(env.check_grasp(kin, *env._grasp_pairs).sum()), int((n_act >= 4).sum())
    return f"the right gripper grasps the cube in {grasp}/{B}; >= 4 active rows in {rich}/{B}", 2 * rich >= B


# the Baxter worlds (phases 85-92): make's arguments, (nq, nv, nbody, ngeom,
# nsite, nu, npair), the contact state of ab_kernels and its check, the
# first phase, and what runs: "full" (K1 at B and 32, K2, reset + STEPS
# steps with EARLIER_HELD held, one MPPI tick), "held" (K2, reset +
# EARLIER_HELD steps, all held) or "launches" (one K1 and one K2 launch)
BAXTER_WORLDS = {
    "Lift-Baxter": (("Lift", dict(seed=SEED)), (25, 24, 44, 118, 17, 18, 351), "lift_grasp_state", _lift_grasped,
                    85, "full"),
    "TwoArmLift-Baxter": (("TwoArmLift", {}), (25, 24, 44, 127, 20, 18, 761), "twoarm_lift_contact_state",
                          _twoarm_lift_rich, 88, "held"),
    "TwoArmTransport-Baxter": (("TwoArmTransport", {}), (39, 36, 50, 127, 24, 18, 1179), "transport_contact_state",
                               _transport_rich, 91, "launches"),
}


def baxter_world(tag, results, name):
    """One Baxter world on the unfused path (the fused gate refuses the
    bimanual robot as multi-arm, as the JAX gate does): the world and the
    gate, K1's and K2's shared memory a block, the contact state, the
    contact rows graph (rows_graph_report), then what BAXTER_WORLDS gives
    it. -> {path: launch counts}."""
    import torch

    import robosuite_tpu_torch as R
    from robosuite_tpu_torch import ab_kernels
    from robosuite_tpu_torch.ops import forward
    from robosuite_tpu_torch.physics import contact as C

    (env_name, kw), sizes, state_fn, state_check, ph, depth = BAXTER_WORLDS[name]
    env = R.make(env_name, robots="Baxter", reward_shaping=True, **kw)
    model = env.model
    nrows = sum(len(r) for r in C.contact_row_layout(model).values())
    K = min(C.ROW_CAP, nrows)
    got = (model.nq, model.nv, model.nbody, model.ngeom, model.nsite, model.nu, model.npair)
    print(f"{name} world: nq={got[0]} nv={got[1]} nbody={got[2]} ngeom={got[3]} nsite={got[4]} nu={got[5]} "
          f"npair={got[6]}, {nrows} candidate rows compacted into {K} slots; action_dim {env.action_dim}; "
          f"configuration {getattr(env, 'env_configuration', 'one robot')}")
    if got != sizes or not C.uses_row_compaction(model) or env.action_dim != 14:
        fail(f"the {name} world is {got}, not {sizes}, or does not compact its rows, or its action is not 14 wide")
    refused_by_gate(name, env, model, "multi-arm")
    unfused_smem(name, model, K, 0, results)
    world_k = results.setdefault("unfused_kernels", {}).setdefault(name, {})
    gen = torch.Generator(device="cuda").manual_seed(SEED + ph)
    states = valid_resets(env, B, gen)[0]
    if depth == "full":
        unfused_k1(tag, name, model, states, (B, H64_B), world_k, results)
    phase_done(f"{name} world, gate" + (", K1" if depth == "full" else ""))
    s = getattr(ab_kernels, state_fn)(env, states)
    q, qd = s.physics.qpos, s.physics.qvel
    if not (torch.isfinite(q).all() and torch.isfinite(qd).all()):
        fail(f"the {name} contact state is not finite")
    kin, M, bias = forward.forward_plain(model, q, qd, *forward.runtime_leaves(model, B))
    con = C.narrowphase(model, kin)
    n_act = (con["dist"] < con["margin"]).sum(1)
    report, rich = state_check(env, kin, n_act)
    print(f"{name} contact state: active rows per scenario min {int(n_act.min())} median {int(n_act.median())} "
          f"max {int(n_act.max())}; the {K}-slot cap drops rows in {int((n_act > K).sum())}/{B}; {report}")
    if not rich:
        fail(f"the {name} contact state is too poor: {report}")
    rows_graph_report(tag, name, model, kin, qd, results)
    if depth == "launches":
        world_k["K1"] = dict(max_abs_err=hold_k1(f"{name} K1 (B={B}, the contact state)", model, q, qd),
                             **{k: v for k, v in time_width(
                                 tag, f"K1 {name}", lambda: forward.forward_products(model, q, qd),
                                 lambda: forward.forward_plain(model, q, qd, *forward.model_leaves(model, B)), 20,
                                 k1_bytes(model, B), op_counts(model, 0)["K1"], B).items() if k != "B"})
        world_k["K1"]["bound"] = (world_k["K1"].pop("bound_ms"), world_k["K1"].pop("bound_by"))
    phase_done(f"{name} contact state, rows graph")
    unfused_k2(name, env, states, s, kin, M, bias, con, K, world_k)
    out = {}
    if depth != "launches":
        steps = STEPS if depth == "full" else EARLIER_HELD
        key = name.lower().replace("-", "_")
        counts, _, (trail, obs_all, _) = unfused_step_slice(tag, name, env, gen, results, key, None, False, steps)
        left = [o.get("robot0_left_eef_force") for o in obs_all]
        if any(f is None or f.shape != (B, 3) or bool(f.any()) for f in left):
            fail(f"{name} step_batch: robot0_left_eef_force missing or nonzero (the JAX package's is 0 on a world "
                 f"that compacts its rows)")
        out[f"{name} step"] = counts
        if depth == "full":
            out[f"{name} MPC"] = unfused_mpc(tag, name, env, H64_MPC, H64_B, 1,
                                             torch.Generator(device="cuda").manual_seed(SEED + ph + 1),
                                             torch.Generator(device="cuda").manual_seed(SEED + ph + 2), results, key,
                                             (states, s), world_k, False)
    for k, r in world_k.items():
        print(f"{tag} {name} {k}: {r['ms']:.4f} ms/launch at B={B} ({r['dev_ms']:.4f} ms device), plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound'][0]:.5f} ms ({r['bound'][1]})")
    return out


def dex_contact_holds(tag, results):
    """Phases 83-84: Stack-PandaDexLH and Door-PandaDexRH, one K3 and one
    K3-aux launch each at B=512 at a state in contact
    (dex_contact_state), against their plain versions; the carve."""
    import torch

    for name, env_name, robot, kw in (("Stack-PandaDexLH", "Stack", "PandaDexLH", {}),
                                      ("Door-PandaDexRH", "Door", "PandaDexRH", dict(seed=SEED))):
        env = fused_world(name, env_name, robot, **kw)
        fused_carve(tag, name, env, env.model, results)
        states = env.reset_batch(B, torch.Generator(device="cuda").manual_seed(SEED + 85))[0]
        s = dex_contact_state(env, states, name)
        plan = env.model.replace(timestep=0.025, solver_iters=10)
        hold_fused_launch(tag, f"{name} K3", env, env.model, s, False, results, f"{name} K3")
        hold_fused_launch(tag, f"{name} K3-aux (planning model)", env, plan, s, True, results, f"{name} K3-aux")
        phase_done(f"{name} K3 and K3-aux at a state in contact")
        del env


def robots_slice(tag, results):
    """Phases 81-92, the robots that need no new physics. 81, Lift with
    PandaDexRH (an Inspire hand: a 12-wide gripper command, K3's gripper
    maximum raised to 12), fused: the carve, counts zeroed, reset + STEPS
    rollout_batch policy steps, the first EARLIER_HELD held substep by
    substep, STEPS steady steps, and the MPC at bench.py's Lift shape
    (dex_mpc_tick: K3-aux, K4 and K1 at the sweep's width held); 82, Lift
    with SpotArm (6 arm dofs, the BD gripper), fused: reset + EARLIER_HELD
    step_batch steps held, one MPPI tick; 83-84, Stack with PandaDexLH
    (nv 31, the widest fused world: its carve) and Door with PandaDexRH (24
    sites, plane-cylinder and cylinder-cylinder pairs): one K3 and one
    K3-aux launch each at B=512, at a state in contact, against their plain
    versions; 85-92, the Baxter worlds (baxter_world), unfused. -> {path:
    launch counts}."""
    import torch

    out = {}
    # ---- 81. Lift-PandaDexRH
    name = "Lift-PandaDexRH"
    env = fused_world(name, "Lift", "PandaDexRH", seed=SEED)
    fused_carve(tag, name, env, env.model, results)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 81)
    actions = ctrl_actions(env, None, gen)
    out[f"{name} step"], trail = fused_step_slice(tag, name, env, gen, results, "lift_dex", actions, STEPS,
                                                  held=EARLIER_HELD, rollout=True)
    t0, s_ss = time.perf_counter(), trail[-1]
    for _ in range(STEPS):
        s_ss = env.rollout_batch(s_ss, actions)[0]
    torch.cuda.synchronize()
    steady = B * STEPS / (time.perf_counter() - t0)
    print(f"{tag} {name} env policy-steps/s (B={B}, host clock): {steady:.1f} steady ({STEPS} rollout_batch steps "
          f"after the run)")
    results["lift_dex_policy_steps_per_s"] = steady
    hold_fused_launch(tag, f"{name} K3", env, env.model, trail[-1], False, results, f"{name} K3")
    phase_done(f"{name} rollout slice")
    out[f"{name} MPC"] = dex_mpc_tick(tag, name, env, results, "lift_dex", SEED + 82)
    phase_done(f"{name} MPC tick (FD iLQR) at bench.py's shape, K3-aux, K4, K1 at the sweep's width")
    del env

    # ---- 82. Lift-SpotArm
    name = "Lift-SpotArm"
    env = fused_world(name, "Lift", "SpotArm", seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 83)
    actions = ctrl_actions(env, None, gen)
    out[f"{name} step"], trail = fused_step_slice(tag, name, env, gen, results, "lift_spot", actions, EARLIER_HELD)
    hold_fused_launch(tag, f"{name} K3", env, env.model, trail[-1], False, results, f"{name} K3")
    out[f"{name} MPC"] = fused_mppi_tick(tag, name, env, results, "lift_spot", SEED + 84)
    phase_done(f"{name} step slice and MPPI tick")
    del env

    dex_contact_holds(tag, results)
    # ---- 85-92. the Baxter worlds, unfused
    for name in BAXTER_WORLDS:
        out.update(baxter_world(tag, results, name))
        phase_done(f"{name}")
    return out


def _lift_resting(env, kin, n_act):
    rich = int((n_act >= 4).sum())
    return f"the cube rests on the table, >= 4 active rows in {rich}/{B}", 2 * rich >= B


# the tendon and equality worlds (phases 93-100): the robot, (nq, nv, nbody,
# nsite, nu, ntendon, neq), the contact state of ab_kernels and its check,
# the first phase, what runs: "full" (K1 at B and 32, K2, reset + STEPS
# steps with EARLIER_HELD held, one MPPI tick, one FD-iLQR tick: the
# FD-iLQR sweep over a world that carries tendons and compacts its rows
# into 96 slots; the steady rate, the profiled step and the profiled
# ticks cut since the wheeled and legged worlds), "step" (the same with K1 at B
# alone and no FD-iLQR tick) or "k2" (K2, reset + EARLIER_HELD steps, all
# held), and how a
# held substep is held: whole (kernel substep against plain substep from
# the same input, hold_all) or launch by launch (every K1 and K2 launch
# against its plain version on its own operands, the kernel chain equal to
# step_batch's). The Robotiq 85 and 140 worlds (UR5e, Kinova3, IIWA), as
# in the JAX package: their finger links swing at 100-200 rad/s from the
# reset on, and their fingertip boxes meet face to face within the first
# policy step, in more than half the scenarios at once; there the box-box
# SAT's axes tie and the float32 solve is ill-conditioned, so the kernel
# substep and the plain one from the same input part by up to thousands of
# rad/s. XArm7: its four-bar's connect rows are near-dependent (each
# regularised by 0.05 of its diagonal), and one substep's solver forces of
# the two paths parted by 1.8x the tolerance, each within 0.9x of its own
# float64 solve (PERF.md §6). Every launch of theirs agrees with its
# plain version within the launch holds' tolerances (2.8e-5 at most, relative). UR5e's contact state is the settled one: a
# grasp whips the Robotiq 85's fingers faster still, to a state that is not
# finite in a few scenarios of 512.
TENDON_WORLDS = {
    "Lift-UR5e": ("UR5e", (19, 18, 27, 9, 8, 2, 0), "settled", _lift_resting, 93, "full", False),
    "Lift-XArm7": ("XArm7", (20, 19, 27, 13, 8, 1, 3), "lift_grasp_state", _lift_grasped, 96, "step", False),
    "Lift-IIWA": ("IIWA", (20, 19, 28, 9, 9, 4, 4), "lift_grasp_state", _lift_grasped, 98, "k2", False),
    "Lift-Jaco": ("Jaco", (20, 19, 29, 9, 10, 3, 3), "lift_grasp_state", _lift_grasped, 99, "k2", True),
    "Lift-Kinova3": ("Kinova3", (20, 19, 28, 9, 9, 2, 0), "settled", _lift_resting, 100, "k2", False),
}
# the worlds the raised maxima take (phases 101-105): the env, the robot,
# (nq, nv, nsite), the fused gate's refusal, and one MPPI tick or not
WIDE_WORLDS = {
    "PickPlaceCan-Baxter": ("PickPlaceCan", "Baxter", (46, 42, 19), "multi-arm", True),
    "PickPlaceCan-PandaDexRH": ("PickPlaceCan", "PandaDexRH", (47, 43, 22), "compacts", False),
    "NutAssemblySingle-Baxter": ("NutAssemblySingle", "Baxter", (32, 30, 28), "multi-arm", False),
    "NutAssemblySingle-PandaDexRH": ("NutAssemblySingle", "PandaDexRH", (33, 31, 31), "compacts", False),
}


def unfused_smem(name, model, K, ne, results):
    """K1's and K2's shared memory a block at this world (K2 at nv, K
    contact rows and ne equality rows) against the card's opt-in limit,
    with the scenarios a block each launch takes. -> those scenarios (K1,
    K2)."""
    from robosuite_tpu_torch.ops import build, forward

    lib = build.library()
    T_host = forward.model_tables(model)[1].data_ptr()
    k1_smem, k1_s = lib.rs_forward_smem_bytes(T_host), lib.rs_forward_scenarios(T_host)
    k2_smem, k2_s = lib.rs_contact_solve_smem_bytes(model.nv, K, ne), lib.rs_contact_solve_scenarios(model.nv, K, ne)
    optin = lib.rs_smem_limit()
    print(f"{name} shared memory a block: K1 {k1_smem} B ({k1_s} scenarios), K2 {k2_smem} B ({k2_s} scenarios at "
          f"nv {model.nv}, {K} contact rows, {ne} equality rows); the card's opt-in limit {optin} B")
    if not 0 < max(k1_smem, k2_smem) <= optin:
        fail(f"{name}: a K1 or K2 block's shared memory is past the card's opt-in limit {optin} B")
    results["smem_bytes"].update({f"K1 {name} block": k1_smem, f"K2 {name} block": k2_smem})
    results.setdefault("block_scenarios", {}).update({f"K1 {name}": k1_s, f"K2 {name}": k2_s})
    return k1_s, k2_s


def refused_by_gate(name, env, model, refusal):
    """The fused gate refuses the world for `refusal`, as the JAX gate does."""
    from robosuite_tpu_torch.ops import substep

    try:
        substep.extract_spec(env, model)
        fail(f"the fused substep's gate takes {name}")
    except substep.UnsupportedFused as e:
        print(f"{name} fused gate: UnsupportedFused({e})")
        if refusal not in str(e):
            fail(f"the fused gate does not refuse {name} for '{refusal}'")
    if env._fused_for(model) is not None:
        fail(f"the {name} env has a fused substep")


def contact_state(name, env, states, state_fn, state_check):
    """The contact state an unfused world's K2 is held and timed at:
    LIFT_SETTLE_STEPS zero-action steps from `states` ("settled") or an
    ab_kernels state; finite, and rich enough by state_check."""
    import torch

    from robosuite_tpu_torch import ab_kernels
    from robosuite_tpu_torch.physics import contact as C

    s = (ab_kernels._settle(env, states, ab_kernels.LIFT_SETTLE_STEPS) if state_fn == "settled"
         else getattr(ab_kernels, state_fn)(env, states))
    if not (torch.isfinite(s.physics.qpos).all() and torch.isfinite(s.physics.qvel).all()):
        fail(f"the {name} contact state is not finite")
    kin = plain_products(env, s)[0]
    con = C.narrowphase(env.model, kin)
    n_act = (con["dist"] < con["margin"]).sum(1)
    report, rich = state_check(env, kin, n_act)
    print(f"{name} contact state ({state_fn}): active rows per scenario min {int(n_act.min())} median "
          f"{int(n_act.median())} max {int(n_act.max())}; {report}")
    if not rich:
        fail(f"the {name} contact state is too poor: {report}")
    return s


def plain_products(env, s):
    """(kin, M, bias, narrowphase) of the plain path at the state s."""
    from robosuite_tpu_torch.ops import forward
    from robosuite_tpu_torch.physics import contact as C

    q, qd = s.physics.qpos, s.physics.qvel
    kin, M, bias = forward.forward_plain(env.model, q, qd, *forward.runtime_leaves(env.model, q.shape[0]))
    return kin, M, bias, C.narrowphase(env.model, kin)


def tendon_world(tag, results, name):
    """One Lift world whose gripper couples its fingers with fixed tendons
    and equality constraints, on the unfused path (K1, the contact and
    equality rows as one CUDA graph a substep, K2 with its ne equality
    rows; the fused gate refuses tendons as the JAX gate does): the world,
    the gate, the carves, then what TENDON_WORLDS gives it. -> {path:
    launch counts}."""
    import torch

    import robosuite_tpu_torch as R
    from robosuite_tpu_torch.physics import contact as C
    from robosuite_tpu_torch.physics.equality import equality_row_count

    robot, sizes, state_fn, state_check, ph, depth, whole = TENDON_WORLDS[name]
    env = R.make("Lift", robots=robot, reward_shaping=True, seed=SEED)
    model = env.model
    nrows = sum(len(r) for r in C.contact_row_layout(model).values())
    compacts = C.uses_row_compaction(model)
    K, ne = (min(C.ROW_CAP, nrows) if compacts else nrows), equality_row_count(model)
    got = (model.nq, model.nv, model.nbody, model.nsite, model.nu, model.ntendon, model.neq)
    print(f"{name} world: nq={got[0]} nv={got[1]} nbody={got[2]} nsite={got[3]} nu={got[4]} ntendon={got[5]} "
          f"neq={got[6]} ({', '.join(model.eq_kind) or 'none'}: {ne} rows); actuators {sorted(set(model.actuator_kind))}; "
          f"{nrows} candidate rows, {f'compacted into {K} slots' if compacts else 'static'}; action_dim "
          f"{env.action_dim}")
    if got != sizes or env.action_dim != 7:
        fail(f"the {name} world is {got}, not {sizes} (nq, nv, nbody, nsite, nu, ntendon, neq), or its action is "
             f"not 7 wide")
    refused_by_gate(name, env, model, "tendons")
    unfused_smem(name, model, K, ne, results)
    world_k = results.setdefault("unfused_kernels", {}).setdefault(name, {})
    gen = torch.Generator(device="cuda").manual_seed(SEED + ph)
    states = valid_resets(env, B, gen)[0]
    if depth != "k2":
        unfused_k1(tag, name, model, states, (B, H64_B) if depth == "full" else (B,), world_k, results)
    phase_done(f"{name} world, gate" + (", K1" if depth != "k2" else ""))
    s = contact_state(name, env, states, state_fn, state_check)
    unfused_k2(name, env, states, s, *plain_products(env, s), K, world_k)
    out = {}
    key = name.lower().replace("-", "_")
    steps = EARLIER_HELD if depth == "k2" else STEPS
    out[f"{name} step"], last, _ = unfused_step_slice(tag, name, env, gen, results, key, None, False, steps,
                                                      held=EARLIER_HELD, whole=whole)
    if depth != "k2":
        out[f"{name} MPC"] = unfused_mpc(tag, name, env, H64_MPC, H64_B, 1,
                                         torch.Generator(device="cuda").manual_seed(SEED + ph + 1),
                                         torch.Generator(device="cuda").manual_seed(SEED + ph + 2), results, key,
                                         (states, last), world_k, False)
    if depth == "full":
        out[f"{name} iLQR"] = fd_ilqr_tick(tag, name, env, results, key, SEED + ph + 3)
        phase_done(f"{name} MPC ticks (MPPI, FD iLQR)")
    for k, r in world_k.items():
        print(f"{tag} {name} {k}: {r['ms']:.4f} ms/launch at B={B} ({r['dev_ms']:.4f} ms device), plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound'][0]:.5f} ms ({r['bound'][1]})")
    return out


def wide_world(tag, results, name):
    """One world the raised maxima take (nq 48, nv 44, 32 sites), on the
    unfused path (its rows compact into 96 slots): the world and the gate,
    the carves, K1 at B against its plain version and timed, reset +
    EARLIER_HELD step_batch steps with every K1 and K2 launch held, K2 at
    their last state against its plain version and timed, and one MPPI
    tick where WIDE_WORLDS asks. -> {path: launch counts}."""
    import torch

    import robosuite_tpu_torch as R
    from robosuite_tpu_torch.physics import contact as C

    env_name, robot, sizes, refusal, mppi = WIDE_WORLDS[name]
    env = R.make(env_name, robots=robot, reward_shaping=True)
    model = env.model
    got = (model.nq, model.nv, model.nsite)
    print(f"{name} world: nq={got[0]} nv={got[1]} nbody={model.nbody} ngeom={model.ngeom} nsite={got[2]} "
          f"nu={model.nu} npair={model.npair}; action_dim {env.action_dim}")
    if got != sizes or not C.uses_row_compaction(model):
        fail(f"the {name} world is {got}, not {sizes} (nq, nv, nsite), or does not compact its rows")
    refused_by_gate(name, env, model, refusal)
    unfused_smem(name, model, C.ROW_CAP, 0, results)
    world_k = results.setdefault("unfused_kernels", {}).setdefault(name, {})
    gen = torch.Generator(device="cuda").manual_seed(SEED + 101)
    states = valid_resets(env, B, gen)[0]
    unfused_k1(tag, name, model, states, (B,), world_k, results)
    key = name.lower().replace("-", "_")
    counts, last, _ = unfused_step_slice(tag, name, env, gen, results, key, None, False, EARLIER_HELD)
    out = {f"{name} step": counts}
    # K2 at the held steps' last state (the objects dropped onto the bins or the table)
    unfused_k2(name, env, states, last, *plain_products(env, last), C.ROW_CAP, world_k)
    if mppi:
        out[f"{name} MPC"] = unfused_mpc(tag, name, env, H64_MPC, H64_B, 1,
                                         torch.Generator(device="cuda").manual_seed(SEED + 102),
                                         torch.Generator(device="cuda").manual_seed(SEED + 103), results, key,
                                         (states,), world_k, False)
    return out


def tendons_slice(tag, results):
    """Phases 93-105: the tendon and equality worlds (tendon_world) and the
    worlds the raised maxima take (wide_world). -> {path: launch counts}."""
    out = {}
    for name in TENDON_WORLDS:
        out.update(tendon_world(tag, results, name))
        phase_done(name)
    for name in WIDE_WORLDS:
        out.update(wide_world(tag, results, name))
        phase_done(name)
    return out


# the wheeled and legged worlds (phases 106-115): the robot, its controller
# config (None: the robot's default composite), (nq, nv, nbody, njnt, nsite,
# nu, action_dim), the fused gate's refusal, the first phase, what runs:
# "step" (K1 at B, K2, reset + STEPS steps with EARLIER_HELD held, one
# MPPI tick; PandaOmron's steady rate and profiled step cut for
# the run's time), "held" (K1 at B, K2, reset +
# EARLIER_HELD steps, all held), and how a held substep is held (whole,
# or launch by launch: Tiago's Robotiq 85s swing their fingers at 100-200
# rad/s from the reset, as the UR5e's do); the widths K1 is held and
# timed at. Each world's K2 is held and timed at its settled state (the
# cube at rest on the table, Spot on its feet).
WBIK_OMRON = "robosuite_tpu_torch/controllers/config/robots/default_pandaomron_whole_body_ik.json"
MOBILE_WORLDS = {
    "Lift-PandaOmron": ("PandaOmron", None, (20, 19, 26, 14, 10, 13, 12), "non-fixed-base robot", 106, "step",
                        True, (B,)),
    "Lift-SpotWithArm": ("SpotWithArm", None, (33, 31, 38, 21, 14, 19, 19), "non-fixed-base robot", 108, "step",
                         True, (B,)),
    "Lift-SpotWithArmFloating": ("SpotWithArmFloating", None, (17, 16, 38, 11, 14, 10, 10), "non-fixed-base robot",
                                 110, "held", True, (B,)),
    "Lift-Tiago": ("Tiago", None, (37, 36, 60, 31, 18, 22, 20), "tendons", 112, "held", False, (B, H64_B)),
    "Lift-PandaOmron-WBIK": ("PandaOmron", WBIK_OMRON, (20, 19, 26, 14, 10, 13, 7), "non-fixed-base robot", 114,
                             "held", True, (B,)),
}


def _lift_resting_any(env, kin, n_act):
    rich = int((n_act >= 4).sum())
    return f">= 4 active rows (the cube on the table, feet on the floor) in {rich}/{B}", 2 * rich >= B


def wbik_targets(env, states):
    """(B, action_dim) WHOLE_BODY_IK actions at `states`: each arm's target
    its eef's pose in the arm's base frame (absolute input) moved by up to
    3 cm and 0.05 rad, the grippers open."""
    import torch

    from robosuite_tpu_torch.physics import engine
    from robosuite_tpu_torch.utils import transforms as T

    r, q, qd = env.robots[0], states.physics.qpos, states.physics.qvel
    kin, M, bias = engine.forward_products(env.model, q, qd)
    g = torch.Generator(device="cuda").manual_seed(SEED + 115)
    a = torch.zeros(q.shape[0], env.action_dim, device="cuda")
    idx = r.action_split_indexes()
    for arm in r.arms:
        v = r.arm_view(kin, M, bias, q, qd, arm)
        Rt = v.origin_ori.transpose(1, 2)
        st = idx[arm][0]
        a[:, st:st + 3] = (Rt @ (v.ref_pos - v.origin_pos)[..., None])[..., 0] + 0.03 * torch.rand(
            q.shape[0], 3, generator=g, device="cuda").mul(2).sub(1)
        a[:, st + 3:st + 6] = T.quat2axisangle(T.mat2quat(Rt @ v.ref_ori_mat)) + 0.05 * torch.rand(
            q.shape[0], 3, generator=g, device="cuda").mul(2).sub(1)
        a[:, idx[f"{arm}_gripper"][0]] = -1.0
    return a


def mobile_world(tag, results, name):
    """One wheeled or legged Lift world on the unfused path (the fused gate
    refuses a mobile robot, and Tiago's tendons first, as the JAX gate
    does): the world, its runtime and the gate, K1's and K2's carves, K1
    at its widths against its plain version and timed, K2 at the settled
    state, then what MOBILE_WORLDS gives it. -> {path: launch counts}."""
    import torch

    import robosuite_tpu_torch as R
    from robosuite_tpu_torch.physics import contact as C

    robot, cfg, sizes, refusal, ph, depth, whole, widths = MOBILE_WORLDS[name]
    env = R.make("Lift", robots=robot, controller_configs=cfg, reward_shaping=True, seed=SEED)
    model = env.model
    r = env.robots[0]
    nrows = sum(len(x) for x in C.contact_row_layout(model).values())
    compacts = C.uses_row_compaction(model)
    K = C.ROW_CAP if compacts else nrows
    got = (model.nq, model.nv, model.nbody, model.njnt, model.nsite, model.nu, env.action_dim)
    print(f"{name} world: nq={got[0]} nv={got[1]} nbody={got[2]} njnt={got[3]} nsite={got[4]} nu={got[5]}, "
          f"action_dim {got[6]} {r.action_split_indexes()}; runtime {type(r).__name__}, composite "
          f"{r.composite_type or getattr(r.rm, 'composite_type', 'BASIC')}; {model.npair} pairs, {nrows} candidate "
          f"rows, {f'compacted into {K} slots' if compacts else 'static'}; free joints {model.jnt_type.count(0)}")
    if got != sizes:
        fail(f"the {name} world is {got}, not {sizes} (nq, nv, nbody, njnt, nsite, nu, action_dim)")
    refused_by_gate(name, env, model, refusal)
    unfused_smem(name, model, K, 0, results)
    world_k = results.setdefault("unfused_kernels", {}).setdefault(name, {})
    gen = torch.Generator(device="cuda").manual_seed(SEED + ph)
    states = valid_resets(env, B, gen)[0]
    unfused_k1(tag, name, model, states, widths, world_k, results)
    phase_done(f"{name} world, gate, K1")
    s = contact_state(name, env, states, "settled", _lift_resting_any)
    unfused_k2(name, env, states, s, *plain_products(env, s), K, world_k)
    actions = None
    if r.wbik_spec is not None:  # targets about the step slice's reset, drawn from a copy of its generator
        g2 = torch.Generator(device="cuda")
        g2.set_state(gen.get_state())
        actions = wbik_targets(env, valid_resets(env, B, g2)[0])
    key = name.lower().replace("-", "_")
    out = {}
    out[f"{name} step"], last, _ = unfused_step_slice(tag, name, env, gen, results, key, actions, False,
                                                      EARLIER_HELD if depth == "held" else STEPS,
                                                      held=EARLIER_HELD, whole=whole)
    if depth != "held":
        out[f"{name} MPC"] = unfused_mpc(tag, name, env, H64_MPC, H64_B, 1,
                                         torch.Generator(device="cuda").manual_seed(SEED + ph + 1),
                                         torch.Generator(device="cuda").manual_seed(SEED + ph + 2), results, key,
                                         (states, last), world_k, False)
    for k, v in world_k.items():
        print(f"{tag} {name} {k}: {v['ms']:.4f} ms/launch at B={B} ({v['dev_ms']:.4f} ms device), plain "
              f"{v['plain_ms']:.3f} ms, bound {v['bound'][0]:.5f} ms ({v['bound'][1]})")
    return out


def mobile_slice(tag, results):
    """Phases 106-115: the wheeled and legged robots (mobile_world). ->
    {path: launch counts}."""
    out = {}
    for name in MOBILE_WORLDS:
        out.update(mobile_world(tag, results, name))
        phase_done(name)
    return out


# GR1 and its three variants (phases 116-125), all LeggedRobots on the
# unfused path (the fused gate refuses a non-fixed-base robot, as the JAX
# gate does): the robot, (nq, nv, nbody, njnt, nsite, nu, action_dim), the
# first phase, what runs beyond the common part (the world, its runtime
# and the gate, K1's and K2's blocks, K1 at its widths against its plain
# version and timed, K2 at the settled state, reset + STEPS step_batch
# steps at B with the first EARLIER_HELD held substep by substep):
# "full" (K1 also at 32, the steady rate and a profiled step, the stance,
# one MPPI tick at B=32, H=64, K=16) or "steps", and how a held substep is
# held: whole, or launch by launch where GR1's head and torso move. GR1's
# head-roll box sits 6.5 cm deep in its chest box, and that pair's SAT axes tie
# exactly (margin 0 in float64), so the kernel substep and the plain one
# from the same input keep other contact points there in ~14% of the
# (substep, scenario) cases (the first GR1 run: 3,542 of 25,600 on
# Lift-GR1, each with that witness), and on GR1FixedLowerBody one case
# parted on a choice the witness does not see; every launch agreed with
# its plain version within the launch holds' tolerances. Every world runs
# GR1's 92 bodies: K1 takes 2 scenarios a block where 4 do not fit, and
# GR1's K2 at nv 60 one scenario a block.
GR1_WORLDS = {
    "Lift-GR1": ("GR1", (61, 60, 92, 55, 51, 54, 24), 116, "full", False),
    "Lift-GR1FixedLowerBody": ("GR1FixedLowerBody", (49, 48, 92, 43, 51, 42, 24), 120, "steps", False),
    "Lift-GR1FloatingBody": ("GR1FloatingBody", (52, 51, 92, 46, 51, 45, 34), 122, "steps", False),
    "Lift-GR1ArmsOnly": ("GR1ArmsOnly", (43, 42, 92, 37, 51, 36, 24), 124, "steps", True),
}
STANCE_STEPS = 8  # GR1's zero-action policy steps for the stance (the JAX tests/test_legged_robot.py bound)
STANCE_TOL = 0.15  # metres the torso's root body may move in height over them


def hold_actions(env, states, gen):
    """The actions a GR1 world is settled and driven with: WHOLE_BODY_IK's
    absolute targets about the eefs' poses at `states` (wbik_targets), or
    (GR1FloatingBody) small random deltas for the arms and the hands and
    random base modes, the torso, head and base held (zero: the torso's
    and head's absolute goals at their reset posture, the base at rest).
    Moving GR1's torso and head drives its head-roll box, 6.5 cm deep in its
    chest box, through that pair's exact SAT tie under stiff contact: in
    the first GR1 runs on the card, under random deltas on every part, one
    scenario of 512 reached 7e9 rad/s within a policy step on the kernel
    path and not on the plain one, where the two had parted at a solve that
    each float32 version missed by ~1% of its float64 twin (the kernel the
    closer: solve_conditioning_witness)."""
    import torch

    r = env.robots[0]
    if r.wbik_spec is not None:
        return wbik_targets(env, states)
    a = torch.clamp(0.3 * torch.randn(B, env.action_dim, generator=gen, device="cuda"), -1.0, 1.0)
    idx = r.action_split_indexes()
    for part in ("torso", "head", "base", "legs"):
        if part in idx:
            a[:, slice(*idx[part])] = 0.0
    return a


def gr1_stance(tag, env, gen, results):
    """GR1's stance: STANCE_STEPS step_batch policy steps of zero action
    from a reset at B keep the torso's root body within STANCE_TOL of its
    start in height, every state finite."""
    import torch

    from robosuite_tpu_torch.physics import engine

    model, r = env.model, env.robots[0]
    tb = int(model.jnt_bodyid[model.jnt_name2id(r.rm.torso_joints[0])])
    s = valid_resets(env, B, gen)[0]
    z0 = engine.forward_products(model, s.physics.qpos, s.physics.qvel)[0].xpos[:, tb, 2]
    a = torch.zeros(B, env.action_dim, device="cuda")
    for _ in range(STANCE_STEPS):
        s = env.step_batch(s, a)[0]
    z1 = engine.forward_products(model, s.physics.qpos, s.physics.qvel)[0].xpos[:, tb, 2]
    torch.cuda.synchronize()
    drift = float((z1 - z0).abs().max())
    print(f"{tag} Lift-GR1 stance: torso root body {model.body_names[tb]} at z {float(z0.mean()):.4f} m, after "
          f"{STANCE_STEPS} zero-action policy steps {float(z1.mean()):.4f} m (largest change {drift:.3e} m over {B} "
          f"scenarios; bound {STANCE_TOL} m)")
    if not (torch.isfinite(s.physics.qpos).all() and torch.isfinite(s.physics.qvel).all()):
        fail("Lift-GR1 stance: a state is not finite")
    if not drift < STANCE_TOL:
        fail(f"Lift-GR1 stance: the torso moved {drift:.3f} m in height, past {STANCE_TOL} m")
    results["gr1_stance_drift_m"] = drift


def gr1_k4(tag, model, states, results):
    """K4 (pose-only FK) launched once at GR1's size (B scenarios, 92
    bodies) and held against its plain version (2e-5), then timed; held
    only, so none of its launches counts on a path."""
    from robosuite_tpu_torch.ops import fk

    q = states.physics.qpos.contiguous()
    xp_k, xq_k = fk.fk_pose(model, q)
    xp_p, xq_p = fk.fk_pose_plain(model, q)
    err = max(max_err(xp_k, xp_p), max_err(xq_k, xq_p))
    check(f"Lift-GR1 K4 poses (B={B})", err, 2e-5)
    nb = model.nbody
    row = time_width(tag, "K4 Lift-GR1", lambda: fk.fk_pose(model, q), lambda: fk.fk_pose_plain(model, q), 20,
                     4 * (B * (model.nq + 7 * nb)), op_counts(model, 0)["K4"], B)
    results["gr1_k4"] = dict(max_abs_err=err, **row)


def gr1_world(tag, results, name):
    """One GR1 world in Lift on the unfused path (GR1_WORLDS). -> {path:
    launch counts}."""
    import torch

    import robosuite_tpu_torch as R
    from robosuite_tpu_torch import ab_kernels
    from robosuite_tpu_torch.physics import contact as C

    robot, sizes, ph, depth, whole = GR1_WORLDS[name]
    env = R.make("Lift", robots=robot, reward_shaping=True, seed=SEED)
    model, r = env.model, env.robots[0]
    K = C.ROW_CAP
    got = (model.nq, model.nv, model.nbody, model.njnt, model.nsite, model.nu, env.action_dim)
    print(f"{name} world: nq={got[0]} nv={got[1]} nbody={got[2]} njnt={got[3]} nsite={got[4]} nu={got[5]}, "
          f"action_dim {got[6]} {r.action_split_indexes()}; runtime {type(r).__name__}, composite "
          f"{r.composite_type or getattr(r.rm, 'composite_type', 'BASIC')}, legs actuated {r.is_legs_actuated} "
          f"({r.num_leg_joints} joints); {model.npair} pairs, "
          f"{sum(len(x) for x in C.contact_row_layout(model).values())} candidate rows compacted into {K} slots")
    if got != sizes or not C.uses_row_compaction(model):
        fail(f"the {name} world is {got}, not {sizes} (nq, nv, nbody, njnt, nsite, nu, action_dim), or does not "
             f"compact its rows")
    refused_by_gate(name, env, model, "non-fixed-base robot")
    k1_s, k2_s = unfused_smem(name, model, K, 0, results)
    world_k = results.setdefault("unfused_kernels", {}).setdefault(name, {})
    gen = torch.Generator(device="cuda").manual_seed(SEED + ph)
    states = valid_resets(env, B, gen)[0]
    unfused_k1(tag, name, model, states, (B, H64_B) if depth == "full" else (B,), world_k, results)
    if depth == "full":
        gr1_k4(tag, model, states, results)
    phase_done(f"{name} world, gate, K1")
    s = states  # settled: the cube at rest on the table, the arms held at their poses
    for _ in range(ab_kernels.LIFT_SETTLE_STEPS):
        s = env.rollout_batch(s, hold_actions(env, s, gen))[0]
    kin, M, bias, con = plain_products(env, s)
    n_act = (con["dist"] < con["margin"]).sum(1)
    print(f"{name} settled state: active rows per scenario min {int(n_act.min())} median {int(n_act.median())} max "
          f"{int(n_act.max())}")
    if not (torch.isfinite(s.physics.qpos).all() and 2 * int((n_act >= 4).sum()) >= B):
        fail(f"the {name} settled state is not finite, or has >= 4 active rows in under half the scenarios")
    unfused_k2(name, env, states, s, kin, M, bias, con, K, world_k)
    world_k["K1"]["scenarios_a_block"], world_k["K2"]["scenarios_a_block"] = k1_s, k2_s
    if depth == "full":
        rows_graph_report(tag, name, model, kin, s.physics.qvel, results)
    g2 = torch.Generator(device="cuda")  # the step slice's reset, drawn from a copy of its generator
    g2.set_state(gen.get_state())
    actions = hold_actions(env, valid_resets(env, B, g2)[0], g2)
    key = name.lower().replace("-", "_")
    out = {}
    out[f"{name} step"], last, _ = unfused_step_slice(tag, name, env, gen, results, key, actions, depth == "full",
                                                      STEPS, held=EARLIER_HELD, whole=whole)
    if depth == "full":
        gr1_stance(tag, env, gen, results)
        out[f"{name} MPC"] = unfused_mpc(tag, name, env, H64_MPC, H64_B, 1,
                                         torch.Generator(device="cuda").manual_seed(SEED + ph + 1),
                                         torch.Generator(device="cuda").manual_seed(SEED + ph + 2), results, key,
                                         (states, last), world_k, False)
    for k, v in world_k.items():
        print(f"{tag} {name} {k}: {v['ms']:.4f} ms/launch at B={B} ({v['dev_ms']:.4f} ms device, "
              f"{v['scenarios_a_block']} scenarios a block), plain {v['plain_ms']:.3f} ms, bound "
              f"{v['bound'][0]:.5f} ms ({v['bound'][1]})")
    return out


def gr1_slice(tag, results):
    """Phases 116-125: GR1 and its variants (gr1_world). -> {path: launch
    counts}."""
    out = {}
    for name in GR1_WORLDS:
        out.update(gr1_world(tag, results, name))
        phase_done(name)
    return out


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA GPU")
    sys.path.insert(0, HERE)
    try:
        import robosuite_tpu_torch as R
        from robosuite_tpu_torch.envs.base import map_state
        from robosuite_tpu_torch.mpc import receding
        from robosuite_tpu_torch.ops import build, contact_solve, fk, forward, substep
        from robosuite_tpu_torch.physics import contact as C
        from robosuite_tpu_torch.physics import engine
    except ImportError as e:
        fail(f"robosuite_tpu_torch is not importable next to chip_smoke.py ({e})")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    tag = f"[{card}]"
    results = {"card": card, "kernels": {}}

    # ---- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    build.library()
    print(f"{tag} kernel build+load s: {time.perf_counter() - t0:.1f}")
    results["ptxas"] = ptxas_report(os.path.join(os.path.dirname(build.build()), "build.log"))
    for v, r in results["ptxas"].items():
        print(f"ptxas {v} ({VARIANT_KERNEL[v]}): {r['registers']} registers, {r['spill_stores']} B spill stores, "
              f"{r['spill_loads']} B spill loads, {r['stack_frame']} B stack frame")
    results["resident_per_sm"] = {}

    # ---- 3. env + reset -------------------------------------------------------
    env = R.make("Lift", robots="Panda", reward_shaping=True, seed=SEED)
    model = env.model
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    states, obs = env.reset_batch(B, gen)
    for k, v in obs.items():
        if not torch.isfinite(v).all():
            fail(f"reset observation {k} is not finite")
    torch.cuda.synchronize()
    nrows = sum(len(r) for r in C.contact_row_layout(model).values())
    print(f"world: nq={model.nq} nv={model.nv} nbody={model.nbody} ngeom={model.ngeom} "
          f"npair={model.npair} rows={nrows}")
    flops = op_counts(model, nrows)

    # ---- 4. K1 vs plain ------------------------------------------------------
    phase_done("build, env, reset")
    q, qd = states.physics.qpos, states.physics.qvel
    q_reset = q
    leaves = forward.runtime_leaves(model, B)
    # as the paths call it (the model's own leaves, batch stride 0), and with
    # per-scenario contiguous leaves
    k1_err = max(hold_k1("K1", model, q, qd), hold_k1("K1 (contiguous leaves)", model, q, qd, leaves))
    k1 = time_width(tag, "K1 Lift", lambda: forward.forward_products(model, q, qd),
                    lambda: forward.forward_plain(model, q, qd, *leaves), 20, k1_bytes(model, B), flops["K1"], B)
    results["k1_widths"] = [dict(world="Lift", **k1)]
    results["kernels"]["K1"] = dict(max_abs_err=k1_err, ms=k1["ms"], dev_ms=k1["dev_ms"], plain_ms=k1["plain_ms"],
                                    bound=(k1["bound_ms"], k1["bound_by"]))

    # ---- drive to a contact-rich state: the grip site to the cube, fingers closing
    s = states
    for i in range(16):
        eef = env._get_observations(s.physics, engine.forward_products(model, s.physics.qpos, s.physics.qvel)[0])
        a = torch.zeros(B, env.action_dim, device="cuda")
        a[:, :3] = torch.clamp(-eef["gripper_to_cube_pos"] * 40.0, -1.0, 1.0)
        a[:, 6] = -1.0 if i < 12 else 1.0
        s, _ = env.rollout_batch(s, a)
    torch.cuda.synchronize()
    q, qd = s.physics.qpos, s.physics.qvel
    if not (torch.isfinite(q).all() and torch.isfinite(qd).all()):
        fail("driven state is not finite")

    # ---- 5. K2 vs plain, on operands formed by the plain path -----------------
    kin, M, bias = forward.forward_plain(model, q, qd, *leaves)
    robot = env.robots[0]
    ctrl = robot.run_controllers(kin, M, bias, q, qd, s.ctrl, torch.zeros(B, model.nu, device="cuda"))
    qfrc, extra = engine.total_smooth_force(model, q, qd, ctrl, M, bias)
    con = C.narrowphase(model, kin)
    JfT, aref, reg3, mu, act = C.solver_inputs(model, kin, con, qd, model.timestep)
    damp = (model.dof_damping + extra).contiguous()
    args = (M.contiguous(), JfT, aref.contiguous(), qfrc.contiguous(), qd.contiguous(), damp, reg3.contiguous(),
            mu, act.contiguous())
    n_act = act.sum(1)
    finger = [r for k in sum(env._grasp_pairs, []) for r in C.contact_row_layout(model)[k]]
    print(f"active contact rows per scenario: min {int(n_act.min())} median {int(n_act.median())} "
          f"max {int(n_act.max())}; scenarios with a fingerpad-cube contact: "
          f"{int((act[:, finger].sum(1) > 0).sum())}/{B}")
    if int(n_act.max()) < 4:
        fail("fewer than 4 active contact rows at the contact state")
    flops = op_counts(model, nrows, float(n_act.float().mean()))  # K2 and K3 run at this state
    solve_args = (C.APGD_ITERS, C.POWER_ITERS, model.timestep)
    qv_k, f_k = contact_solve.vel_update(*args, *solve_args)
    qv_p, f_p = contact_solve.vel_update_plain(*args, *solve_args)
    torch.cuda.synchronize()
    f_scale = max(1.0, float(f_p.abs().max()))
    # the kernel factors M in double and sums rows in another order; 38
    # APGD/power iterations carry that float32 difference into f
    check("K2 qvel", max_err(qv_k, qv_p), 1e-4)
    check("K2 f (relative)", max_err(f_k, f_p) / f_scale, 1e-4)
    k2_ms = cuda_ms(lambda: contact_solve.vel_update(*args, *solve_args), 20)
    k2_plain = cuda_ms(lambda: contact_solve.vel_update_plain(*args, *solve_args), 3)
    results["kernels"]["K2"] = dict(max_abs_err=max(max_err(qv_k, qv_p), max_err(f_k, f_p)), ms=k2_ms,
                                    plain_ms=k2_plain, bound=bound(nbytes(*args, qv_k, f_k), flops["K2"], B))

    # ---- 6. K3 vs plain at the same state --------------------------------------
    fused = env._fused_for(model)
    goal, gains = env._fused_goal_fn(robot, "right", s.ctrl, kin)
    grip = robot.gripper_ctrl("right", s.ctrl).contiguous()
    k3_args = (q, qd, *leaves, goal, gains, grip)
    qp_k, qv_k, f_k = fused(*k3_args)
    qp_p, qv_p, f_p = substep.substep_plain(env, model, *k3_args)
    torch.cuda.synchronize()
    # qvel: a contact impulse on a gram-scale finger link turns the float32
    # rounding of f (checked above, 1e-4 relative) into ~1e-4 of velocity
    check("K3 qpos", max_err(qp_k, qp_p), 1e-5)
    check("K3 qvel", max_err(qv_k, qv_p), 1e-3)
    results["resident_per_sm"]["K3"] = substep.resident_per_sm(fused)
    print(f"K3 resident scenarios per SM (Lift): {results['resident_per_sm']['K3']}")
    k3_ms = cuda_ms(lambda: fused(*k3_args), 20)
    k3_plain = cuda_ms(lambda: substep.substep_plain(env, model, *k3_args), 3)
    results["kernels"]["K3"] = dict(
        max_abs_err=max(max_err(qp_k, qp_p), max_err(qv_k, qv_p)), ms=k3_ms, plain_ms=k3_plain,
        bound=bound(nbytes(*k3_args, qp_k, qv_k, f_k), flops["K3"], B))
    torch.cuda.synchronize()

    # ---- 7. the slice ------------------------------------------------------------
    actions = 0.1 * torch.randn(B, env.action_dim, generator=gen, device="cuda")
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states, _ = env.reset_batch(B, gen)
    rewards = []
    for i in range(STEPS):
        states, r = env.rollout_batch(states, actions)
        rewards.append(r)
        if i == 4:
            start = states  # the cube has landed and rests: no contact onset in the compared step
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kcounts()
    take_widths("Lift")
    print(f"main path launches over reset + {STEPS} policy steps: {counts}")
    if (counts["K3"] != 25 * STEPS or counts["K1"] != 2 * STEPS + 1 or counts["K2"] != 0
            or counts["K3-aux"] != 0 or counts["K4"] != 0):
        fail(f"unexpected launch counts {counts}")
    rew = torch.stack(rewards)
    if not (torch.isfinite(states.physics.qpos).all() and torch.isfinite(states.physics.qvel).all()
            and torch.isfinite(rew).all()):
        fail("non-finite states or rewards on the main path")
    print(f"{tag} env policy-steps/s (B={B}, reset + {STEPS} steps, host clock): {B * STEPS / dt:.1f}")
    print(f"rewards: mean {float(rew.mean()):.4f} max {float(rew.max()):.4f}")
    results.update(policy_steps_per_s=B * STEPS / dt, launches=counts)

    # steady state: policy steps only (no reset), host clock
    t0 = time.perf_counter()
    s_ss = states
    for _ in range(STEPS):
        s_ss, _ = env.rollout_batch(s_ss, actions)
    torch.cuda.synchronize()
    steady = B * STEPS / (time.perf_counter() - t0)
    print(f"{tag} env policy-steps/s (B={B}, {STEPS} steps after the above, host clock): {steady:.1f}")
    results.update(steady_policy_steps_per_s=steady)

    # where one policy step's time goes: device time by kernel vs wall time
    _, wall_ms, dev_ms, top, port = profile_once(tag, "one policy step",
                                                 lambda: env.rollout_batch(states, actions), 6)
    results.update(profile_wall_ms=wall_ms, profile_device_ms=dev_ms, profile_top=top, profile_port=port)

    # one policy step: kernel path vs the plain composition on the card
    s1, r1 = env.rollout_batch(start, actions)
    kin, M, bias = forward.forward_plain(model, start.physics.qpos, start.physics.qvel, *leaves)
    ctrl_s = robot.set_goals(kin, M, bias, start.physics.qpos, start.physics.qvel, start.ctrl, actions)
    goal, gains = env._fused_goal_fn(robot, "right", ctrl_s, kin)
    grip = robot.gripper_ctrl("right", ctrl_s).contiguous()
    qp, qv = start.physics.qpos, start.physics.qvel
    for _ in range(env.n_substeps):
        qp, qv, _ = substep.substep_plain(env, model, qp, qv, *leaves, goal, gains, grip)
    kin2, _, _ = forward.forward_plain(model, qp, qv, *leaves)
    r_plain = env.reward(engine.State(qpos=qp, qvel=qv, time=start.physics.time), kin2)
    torch.cuda.synchronize()
    # The arm and fingers (qpos[:9], qvel[:9]) are held in every scenario. The
    # free cube is held at the 99th percentile over scenarios: where two of
    # its contact candidates lie within float rounding of each other, the
    # manifold cut may keep the other one in a few scenarios, and the cube's
    # velocity then differs by that contact point's share of the impulse.
    hold_step("policy step (kernel vs plain)", s1, qp, qv)
    check("policy step reward (kernel vs plain)", max_err(r1, r_plain), 1e-4)

    # one step with the fused path disabled: K1 every substep + K2
    env._disable_fused = True
    zero_counts()
    s2, r2 = env.rollout_batch(start, actions)
    torch.cuda.synchronize()
    env._disable_fused = False
    counts_u = kcounts()
    take_widths("Lift")
    print(f"unfused policy step launches: {counts_u}")
    if counts_u != {"K1": env.n_substeps + 2, "K2": env.n_substeps, "K3": 0, "K3-aux": 0, "K4": 0}:
        fail(f"unexpected unfused launch counts {counts_u}")
    hold_step("unfused vs fused policy step", s2, s1.physics.qpos, s1.physics.qvel)
    check("unfused vs fused policy step reward", max_err(r2, r1), 1e-4)
    phase_done("env-step slice (reset + policy steps, profile, kernel vs plain, unfused)")
    sb_counts = lift_step_batch(tag, env, gen, results)

    # ---- 8. K1 at the MPC path's widths and K4 (pose-only FK) vs plain, at
    # random arm poses. K1: 32 (Stack's executed step, here on Lift), 128 (the
    # iLQR nominal rollout), 4096 (the MPPI start, B*K); K4: B=4096 and the
    # iLQR costs at B, B*H, 4*B and 4*B*H (128, 8192, 512, 32768 for
    # bench.py's B=128, H=64 and 4 line-search steps)
    B4, BK4 = 4096, 32768
    g4 = torch.Generator(device="cuda").manual_seed(SEED + 4)
    q4 = q_reset.repeat(BK4 // B, 1)
    q4[:, :7] += 0.5 * torch.randn(BK4, 7, generator=g4, device="cuda")
    qd4 = 0.2 * torch.randn(BK4, model.nv, generator=torch.Generator(device="cuda").manual_seed(SEED + 8),
                            device="cuda")  # its own generator: phase 9 draws from g4 next
    for n in (32, 128, B4):
        hold_k1(f"K1 (B={n})", model, q4[:n], qd4[:n])
    for n in (128, B4):
        q, qd = q4[:n], qd4[:n]
        results["k1_widths"].append(dict(world="Lift", **time_width(
            tag, "K1 Lift", lambda: forward.forward_products(model, q, qd),
            lambda: forward.forward_plain(model, q, qd, *forward.model_leaves(model, n)), 20,
            k1_bytes(model, n), flops["K1"], n)))
    k4_err = 0.0
    for n in (128, 512, B4, 8192, BK4):
        xp_k, xq_k = fk.fk_pose(model, q4[:n])
        xp_p, xq_p = fk.fk_pose_plain(model, q4[:n])
        torch.cuda.synchronize()
        # float32 rounding of chains of ~26 rotations, as K1's poses
        check(f"K4 xpos (B={n})", max_err(xp_k, xp_p), 2e-5)
        check(f"K4 xquat (B={n})", max_err(xq_k, xq_p), 2e-5)
        k4_err = max(k4_err, max_err(xp_k, xp_p), max_err(xq_k, xq_p))
    results["k4_widths"] = [time_width(tag, "K4", lambda n=n: fk.fk_pose(model, q4[:n]),
                                       lambda n=n: fk.fk_pose_plain(model, q4[:n]), 20,
                                       nbytes(q4[:n]) + 4 * n * 7 * model.nbody, flops["K4"], n)
                            for n in (8192, BK4)]
    k4 = results["k4_widths"][-1]
    results["kernels"]["K4"] = dict(max_abs_err=k4_err, ms=k4["ms"], dev_ms=k4["dev_ms"], plain_ms=k4["plain_ms"],
                                    batch=BK4, bound=(k4["bound_ms"], k4["bound_by"]))
    phase_done("K4 vs plain")

    # ---- 9. K3-aux vs plain at the contact-rich state, 2-point planning model ---------
    plan = model.replace(timestep=0.025, solver_iters=10, pair_points_cap=2)
    plan_rows = sum(len(r) for r in C.contact_row_layout(plan).values())
    fused_aux = env._fused_for(plan, emit_aux=True)
    q, qd = s.physics.qpos, s.physics.qvel
    kin = forward.forward_plain(plan, q, qd, *leaves)[0]
    plan_act = C.solver_inputs(plan, kin, C.narrowphase(plan, kin), qd, plan.timestep)[-1]
    aux_flops = op_counts(plan, plan_rows, float(plan_act.sum(1).float().mean()), iters=10)["K3-aux"]
    goal, gains = env._fused_goal_fn(robot, "right", s.ctrl, kin)
    grip = robot.gripper_ctrl("right", s.ctrl).contiguous()
    a_args = (q, qd, *leaves, goal, gains, grip)
    out_k = fused_aux(*a_args)
    out_p = substep.substep_aux_plain(env, plan, *a_args)
    torch.cuda.synchronize()
    print(f"planning model: {plan_rows} contact rows; pairs touching after the step: "
          f"{int((out_p[-1] < 0).sum())} over {B} scenarios")
    # qpos/qvel as K3's; the poses as K1's. A pair distance moves with the
    # geoms' positions, which the qpos tolerance bounds at a ~1 m lever arm
    # (hold_pair_dist sets aside only float64-witnessed cases)
    aux_tols = {"qpos": 1e-5, "qvel": 1e-3, "site_xpos": 2e-5, "site_xmat": 2e-5, "xpos": 2e-5}

    def hold_aux(label, out_k, out_p):
        """Check every output but f; -> the largest error held."""
        errs = []
        for name, a, b in zip(("qpos", "qvel", "f", "site_xpos", "site_xmat", "xpos"), out_k, out_p):
            if name in aux_tols:
                errs.append(max_err(a, b))
                check(f"{label} {name}", errs[-1], aux_tols[name])
        spread(f"{label} pair_dist", out_k[-1], out_p[-1])
        return max(errs + [hold_pair_dist(label, plan, out_k[-1], out_p[-1], out_k[0], out_p[0])])

    aux_err = hold_aux("K3-aux (B=512)", out_k, out_p)
    # the MPPI width B*K = 4096: the contact-rich states, each copy after the
    # first with its own small arm velocity, so that every scenario differs
    a4 = [t.repeat((B4 // B,) + (1,) * (t.dim() - 1)) for t in a_args]
    a4[1] = a4[1].clone()
    a4[1][B:, :7] += 0.05 * torch.randn(B4 - B, 7, generator=g4, device="cuda")
    out4 = fused_aux(*a4)
    out4_p = substep.substep_aux_plain(env, plan, *a4)
    torch.cuda.synchronize()
    aux_err = max(aux_err, hold_aux(f"K3-aux (B={B4})", out4, out4_p))
    # and on a second draw of the offsets from the same seed (the one g4
    # gives when it has first made phase 8's velocities too): a scenario
    # there has a cube edge nearly parallel to a finger pad's (|a x b| 2e-3)
    # at 0.53 m, where the kernel's float32 separation misses float64 by
    # 1.7e-5 and the plain version's by 4.7e-6 the other way
    g9 = torch.Generator(device="cuda").manual_seed(SEED + 4)
    for n in (7, model.nv):
        torch.randn(BK4, n, generator=g9, device="cuda")
    a4b = [t.repeat((B4 // B,) + (1,) * (t.dim() - 1)) for t in a_args]
    a4b[1] = a4b[1].clone()
    a4b[1][B:, :7] += 0.05 * torch.randn(B4 - B, 7, generator=g9, device="cuda")
    out4b, out4b_p = fused_aux(*a4b), substep.substep_aux_plain(env, plan, *a4b)
    torch.cuda.synchronize()
    aux_err = max(aux_err, hold_aux(f"K3-aux (B={B4}, second draw)", out4b, out4b_p))
    results["resident_per_sm"]["K3-aux"] = substep.resident_per_sm(fused_aux)
    print(f"K3-aux resident scenarios per SM (Lift planning model): {results['resident_per_sm']['K3-aux']}")
    results["kernels"]["K3-aux"] = dict(
        max_abs_err=aux_err, ms=cuda_ms(lambda: fused_aux(*a4), 10),
        plain_ms=cuda_ms(lambda: substep.substep_aux_plain(env, plan, *a4), 3), batch=B4,
        bound=bound(nbytes(*a4, *out4), aux_flops, B4))
    phase_done("K3-aux vs plain")
    tangent_checks(tag, "Lift", env, plan, s, 64, results)

    # ---- 10. the planning hooks: kernel path vs plain path on a subset ---------------
    env_m = R.make("Lift", robots="Panda", cube_size=[0.021, 0.021, 0.021], reward_shaping=True)
    mpc_cfg = dict(horizon=64, n_samples=32, noise_sigma=0.4, temperature=0.2, n_knots=8, n_ilqr_iters=1,
                   plan_timestep=0.025, relin_every=4, fd_timestep=0.05, plan_pair_points=2)
    sub = receding.RecedingMPC(env_m, receding.MPCConfig(**dict(mpc_cfg, horizon=8)))
    g10 = torch.Generator(device="cuda").manual_seed(SEED + 10)
    st8 = env_m.reset_batch(8, g10)[0]
    for _ in range(3):  # let the cubes land
        st8, _ = env_m.rollout_batch(st8, torch.zeros(8, env_m.action_dim, device="cuda"))
    flat_st = map_state(lambda x: x.repeat_interleave(32, dim=0), st8)
    seqs = torch.clamp(0.4 * torch.randn(256, 8, env_m.action_dim, generator=g10, device="cuda"), -1.0, 1.0)
    disc = torch.ones(8, device="cuda")
    ret_k = sub.plan_rollout_return(flat_st, seqs, disc)
    with plain_path(env_m):
        ret_p = env_m.make_plan_return(sub.plan_model, sub.plan_substeps)(flat_st, seqs, disc)
    e = (ret_k - ret_p).abs()
    print(f"planning returns (8 solves x 32 samples, H=8), kernel vs plain: median {float(e.median()):.3e} "
          f"p99 {float(torch.quantile(e, 0.99)):.3e} max {float(e.max()):.3e}")
    # eight planned steps; the returns sum rewards of order 1 (8.5e-7 measured)
    check("planning returns, every rollout (kernel vs plain)", float(e.max()), 1e-5)

    # the forward-difference sweep at bench.py's width, B*H*(1 + nx + nu)
    # scenarios in one dynamics call (one K1 and one K3 launch), before the
    # division by eps; the plain path on a strided sample of its rows
    MB, TICKS = 128, 4
    cfg = receding.MPCConfig(**mpc_cfg)
    mpc = receding.RecedingMPC(env_m, cfg)
    st = env_m.reset_batch(MB, g10)[0]
    for _ in range(3):  # let the cubes land
        st, _ = env_m.rollout_batch(st, torch.zeros(MB, env_m.action_dim, device="cuda"))
    H, A, nx = cfg.horizon, env_m.action_dim, mpc.nx
    xs = mpc._to_x(st).repeat_interleave(H, dim=0)                                  # (B*H, nx)
    us = torch.clamp(0.4 * torch.randn(MB * H, A, generator=g10, device="cuda"), -1.0, 1.0)
    eye = torch.eye(nx + A, device="cuda")
    X = torch.cat([xs[:, None], xs[:, None] + 1e-3 * eye[None, :, :nx]], dim=1).reshape(-1, nx)
    U = torch.cat([us[:, None], us[:, None] + 1e-3 * eye[None, :, nx:]], dim=1).reshape(-1, A)
    forward.forward_products.launches = substep.make_fused_substep.launches = 0
    F_k = mpc._ilqr_lin_dynamics(X, U)
    torch.cuda.synchronize()
    sweep = (forward.forward_products.launches, substep.make_fused_substep.launches)
    N = X.shape[0]
    rows = torch.cat([torch.arange(0, N, 131, device="cuda"), torch.tensor([N - 1], device="cuda")])
    with plain_path(env_m):
        F_p = mpc._ilqr_lin_dynamics(X[rows], U[rows])
    F_k = F_k[rows]
    torch.cuda.synchronize()
    nq, nv = model.nq, model.nv
    print(f"FD sweep: {N} scenarios, launches (K1, K3) {sweep}; plain path on {rows.numel()} rows; "
          f"peak device memory so far {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    n_lin = max(1, int(round(1.0 / (env_m.control_freq * cfg.fd_timestep))))
    if N != MB * H * (1 + nx + A) or sweep != (1, n_lin):
        fail(f"the FD sweep ran {N} scenarios with launches {sweep}")
    check("FD dynamics qpos (kernel vs plain)", max_err(F_k[:, :nq], F_p[:, :nq]), 1e-5)
    check("FD dynamics qvel (kernel vs plain)", max_err(F_k[:, nq:nq + nv], F_p[:, nq:nq + nv]), 1e-3)
    check("FD dynamics gripper ramp (kernel vs plain)", max_err(F_k[:, nq + nv:], F_p[:, nq + nv:]), 1e-6)
    del U, F_k, F_p, xs, us
    # K1 alone at the sweep's width, on the sweep's own states (its one K1
    # launch), against the plain version on the strided rows; then timed
    lin = mpc.lin_model
    qx, qvx = X[:, :nq].contiguous(), X[:, nq:nq + nv].contiguous()
    del X
    kin_k, M_k, bias_k = forward.forward_products(lin, qx, qvx)
    kin_k = {f: v[rows] for f, v in kin_k.__dict__.items() if v is not None}
    M_k, bias_k = M_k[rows], bias_k[rows]
    torch.cuda.empty_cache()
    kin_p, M_p, bias_p = forward.forward_plain(lin, qx[rows], qvx[rows], *forward.model_leaves(lin, rows.numel()))
    check(f"K1 poses (B={N}, {rows.numel()} strided rows)", max(max_err(v, getattr(kin_p, f))
                                                                for f, v in kin_k.items()), 2e-5)
    check(f"K1 M (relative, B={N}, strided rows)", max_err(M_k, M_p) / max(1.0, float(M_p.abs().max())), 1e-5)
    check(f"K1 bias (relative, B={N}, strided rows)",
          max_err(bias_k, bias_p) / max(1.0, float(bias_p.abs().max())), 1e-4)
    del kin_k, M_k, bias_k, kin_p, M_p, bias_p
    results["k1_widths"].append(dict(world="Lift", **time_width(
        tag, "K1 Lift", lambda: forward.forward_products(lin, qx, qvx),
        lambda: forward.forward_plain(lin, qx, qvx, *forward.model_leaves(lin, N)), 5, k1_bytes(lin, N),
        flops["K1"], N)))
    del qx, qvx
    torch.cuda.empty_cache()
    phase_done("planning hooks, kernel vs plain")

    # ---- 11. the slice at full width: MPC ticks (bench.py's MPC workload) -------------
    solve = mpc.make_solve_batch()
    gm = torch.Generator(device="cuda").manual_seed(SEED + 2)
    mstates, _ = env_m.reset_batch(MB, gm)
    ms = mpc.init_state(MB, torch.Generator(device="cuda").manual_seed(SEED + 3))

    def tick(states_, ms_):
        actions, ms2, met = solve(states_, ms_)
        states2, rewards = env_m.rollout_batch(states_, actions)
        return states2, ms2, met, actions, rewards

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mstates, ms, met, actions, rewards = tick(mstates, ms)  # warm-up: tick 0, a full relinearization
    torch.cuda.synchronize()
    print(f"{tag} MPC warm-up tick (full relinearization) s: {time.perf_counter() - t0:.3f}")

    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    per_tick, finite, improved, fulls = [], [], [], []
    for i in range(TICKS):
        full = ms.tick_host % cfg.relin_every == 0
        before = kcounts()
        mstates, ms, met, actions, rewards = tick(mstates, ms)
        after = kcounts()
        per_tick.append({k: after[k] - before[k] for k in after})
        fulls.append(full)
        finite.append(met["ilqr_accepted"])
        improved.append(met["ilqr_improved"])
        if not (torch.isfinite(actions).all() and actions.abs().max() <= 1.0 and torch.isfinite(rewards).all()):
            fail(f"MPC tick {i + 1}: non-finite or out-of-range actions, or non-finite rewards")
    torch.cuda.synchronize()
    mpc_dt = time.perf_counter() - t0
    mpc_counts = kcounts()
    take_widths("Lift")
    for i, (got, full) in enumerate(zip(per_tick, fulls)):
        want = tick_launches(cfg, mpc, env_m, full)
        print(f"MPC tick {i + 1} ({'full relinearization' if full else 'frozen linearization'}) launches: {got}")
        if got != want:
            fail(f"MPC tick {i + 1}: launches {got}, the config implies {want}")
    if not any(fulls) or all(fulls):
        fail("the timed MPC ticks must contain both relinearization branches")
    solves = MB * TICKS / mpc_dt
    fin = [int(a.sum()) for a in finite]
    imp = [int(a.sum()) for a in improved]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"{tag} MPC solves/s (B={MB}, H={cfg.horizon}, K={cfg.n_samples}, MPPI + 1 iLQR iteration, "
          f"relin every {cfg.relin_every}; ticks 1-{TICKS}, host clock): {solves:.1f}")
    print(f"{tag} per tick, of {MB} solves: finite iLQR plans {fin}; iLQR line search improved on the MPPI "
          f"plan {imp}; mean executed reward {float(rewards.mean()):.4f}; peak device memory {peak_gb:.2f} GB")
    results.update(mpc_solves_per_s=solves, mpc_launches=mpc_counts, mpc_per_tick=per_tick, mpc_finite=fin,
                   mpc_improved=imp, mpc_peak_gb=peak_gb)
    phase_done("MPC slice at full width")

    # ---- 66-68. the iLQR's AD linearization on Lift: FD and AD ticks at B=AD_B, the associative pass, make_solve
    lift_ad_counts = ad_mpc(tag, "Lift", env_m, mpc_cfg, AD_B, results, "lift", SEED + 20, SEED + 21)[0]
    unbatched_counts = unbatched_tick(tag, env_m, mpc_cfg, results)
    phase_done("Lift AD-linearized MPC, associative pass, one-scenario make_solve")

    stack_counts, stack_mpc_counts, stack_counts_u = stack_slice(tag, results)
    door_counts, door_counts_u, door_mpc_counts = door_slice(tag, results)
    pick_counts, pick_mpc_counts = pickplace_slice(tag, results)
    release_memory("the unfused worlds")
    unfused = {name: unfused_world_slice(tag, results, name) for name in UNFUSED_WORLDS}
    variable_gains_check(results)
    release_memory("the arm controllers")
    ctrl = controllers_slice(tag, results)
    release_memory("the robots")
    robots = robots_slice(tag, results)
    release_memory("the tendon and wide worlds")
    tendons = tendons_slice(tag, results)
    release_memory("the wheeled and legged worlds")
    mobile = mobile_slice(tag, results)
    release_memory("GR1 and its variants")
    gr1 = gr1_slice(tag, results)

    # ---- report ------------------------------------------------------------------
    # launches on each path, counted from zero just before it: Lift's env step
    # and MPC ticks run K3 / K3-aux with the OSC law, Stack's with JOINT_POSITION
    osc = (counts, sb_counts, mpc_counts, door_counts, door_mpc_counts, lift_ad_counts,
           unbatched_counts) + tuple(c for k, c in ctrl.items() if "OSC" in k) + tuple(
        c for k, c in robots.items() if "Baxter" not in k)  # K3 / K3-aux with the OSC law
    every = osc + (counts_u, door_counts_u, stack_counts, stack_counts_u, stack_mpc_counts, pick_counts,
                   pick_mpc_counts) + sum(unfused.values(), ()) + tuple(
        c for k, c in ctrl.items() if "OSC" not in k) + tuple(c for k, c in robots.items() if "Baxter" in k) + tuple(
        tendons.values()) + tuple(mobile.values()) + tuple(gr1.values())
    paths = {"K1": every, "K2": every, "K3": osc, "K3-aux": osc, "K4": every}
    launches = {k: sum(c.get(k, 0) for c in cs) for k, cs in paths.items()}
    launches["K3-JP"] = stack_counts["K3"] + stack_mpc_counts["K3"]
    launches["K3-aux-JP"] = stack_counts["K3-aux"] + stack_mpc_counts["K3-aux"]
    replaces = {
        "K1": ("robosuite_tpu_torch/csrc/forward.cu", "robosuite_tpu/ops/pallas_forward.py:499"),
        "K2": ("robosuite_tpu_torch/csrc/contact_solve.cu", "robosuite_tpu/ops/pallas_contact.py:311"),
        "K3": ("robosuite_tpu_torch/csrc/substep.cu", "robosuite_tpu/ops/pallas_substep.py:1091"),
        "K3-aux": ("robosuite_tpu_torch/csrc/substep.cu", "robosuite_tpu/ops/pallas_substep.py:1091"),
        "K4": ("robosuite_tpu_torch/csrc/fk.cu", "robosuite_tpu/ops/pallas_fk.py:51"),
        "K3-JP": ("robosuite_tpu_torch/csrc/substep.cu", "robosuite_tpu/ops/pallas_substep.py:1091"),
        "K3-aux-JP": ("robosuite_tpu_torch/csrc/substep.cu", "robosuite_tpu/ops/pallas_substep.py:1091"),
    }
    names = {"K1": "forward_products", "K2": "contact_solve", "K3": "fused_substep",
             "K3-aux": "fused_substep_aux", "K4": "fk_pose", "K3-JP": "fused_substep_joint_pos",
             "K3-aux-JP": "fused_substep_aux_joint_pos"}
    print(f"launches over Lift reset + {STEPS} policy steps {counts}, one unfused step {counts_u}, step_batch "
          f"{sb_counts}, MPC ticks 1-{TICKS} {mpc_counts}; over Stack reset + {STEPS} policy steps {stack_counts}, "
          f"one unfused step {stack_counts_u}, MPC ticks 1-{STACK_TICKS} {stack_mpc_counts}; over Door reset + "
          f"{STEPS} step_batch steps {door_counts}, one unfused step {door_counts_u}, MPC ticks 1-{DOOR_TICKS} "
          f"{door_mpc_counts}; over PickPlaceCan reset + {STEPS} step_batch steps {pick_counts}, MPC ticks "
          f"1-{PICK_TICKS} {pick_mpc_counts}; " + "; ".join(
              f"over {n} reset + {STEPS} step_batch steps {c}, MPC ticks 1-{UNFUSED_WORLDS[n][-2]} {m}"
              + (f", AD-linearized MPC ticks 1-{AD_TICKS} {ad[0]}" if ad else "") for n, (c, m, *ad) in unfused.items())
          + f"; Lift AD-linearized MPC ticks 1-{AD_TICKS} {lift_ad_counts}, make_solve {unbatched_counts}; "
          + "; ".join(f"{k} {c}" for k, c in ctrl.items()) + "; " + "; ".join(f"{k} {c}" for k, c in robots.items())
          + "; " + "; ".join(f"{k} {c}" for k, c in tendons.items())
          + "; " + "; ".join(f"{k} {c}" for k, c in mobile.items())
          + "; " + "; ".join(f"{k} {c}" for k, c in gr1.items()))
    by_label = {}
    for a in ASIDE:
        by_label[a.split()[0]] = by_label.get(a.split()[0], 0) + 1
    print(f"(substep, scenario) cases set aside on a float64 near-tie witness over every hold: {len(ASIDE)} "
          f"(by the holds' first word: {by_label})")
    results["set_aside"] = len(ASIDE)
    # K1 and K4 at each width: the launches there over every path (each
    # counted from zero), beside the times of phases 4, 8, 10 and 12
    by_width = {}
    for world, w in WIDTHS:
        for k, per_b in w.items():
            for n, c in per_b.items():
                key = (k, world if k == "K1" else "Lift", n)
                by_width[key] = by_width.get(key, 0) + c
    for r in results["k1_widths"]:
        r["launches"] = by_width.get(("K1", r["world"], r["B"]), 0)
    for r in results["k4_widths"]:
        r["launches"] = by_width.get(("K4", "Lift", r["B"]), 0)
    print(f"K1 and K4 launches by (kernel, world, batch) over the paths: {dict(sorted(by_width.items()))}")
    for label, rows_ in (("K1", results["k1_widths"]), ("K4", results["k4_widths"])):
        for r in rows_:
            print(f"{tag} {label} {r.get('world', 'Lift')} B={r['B']}: launches {r['launches']}, {r['ms']:.4f} ms by "
                  f"events, {r['dev_ms']:.4f} ms device, bound {r['bound_ms']:.5f} ms ({r['bound_by']}), plain "
                  f"{r['plain_ms']:.3f} ms")
    line = []
    for k, r in results["kernels"].items():
        bms, bby = r["bound"]
        print(f"{tag} {k} {names[k]}: {r['ms']:.4f} ms/launch at B={r.get('batch', B)}, plain {r['plain_ms']:.3f} ms, "
              f"bound {bms:.5f} ms ({bby}); launches on the main paths {launches[k]}")
        line.append({"name": names[k], "route": "cuda", "source": replaces[k][0], "replaces": replaces[k][1],
                     "launches": launches[k], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": bms, "bound_by": bby, "library_ms": None})
    if FAILED:
        fail(f"disagreements with the plain versions: {FAILED}")
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({**results, "kernels_line": line}, f, indent=1)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
