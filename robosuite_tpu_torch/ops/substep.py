"""K3, the fused substep kernel: one whole physics substep per launch.

Counterpart of robosuite_tpu/ops/pallas_substep.py (make_fused_substep,
OSC and JOINT_POSITION branches, with and without emit_aux): forward
products -> arm torque law (OSC or JOINT_POSITION) + torque clip +
gripper ctrl -> smooth forces -> narrowphase with the
manifold cut -> contact rows -> cone QP + implicit-damping velocity solve
-> semi-implicit qpos integration [-> with emit_aux, the post-step site
poses, body positions and per-pair minimum distances, which the planning
rollouts read instead of running the forward products].

`substep_plain` / `substep_aux_plain` are the plain versions, the
composition of the port's modules (the JAX make_fused_substep._xla);
`make_fused_substep` returns the wrapper, which runs the plain version on
CPU tensors and launches csrc/substep.cu on CUDA tensors (counted in
`make_fused_substep.launches`, or `.aux_launches` for emit_aux), through
`K3Function` (ops/tangent.py) where an operand carries a derivative.

Goal encoding. OSC (every setting: OSC_POSITION, absolute input, the
world frame; under goal interpolation one row a substep): goal (B, 12) =
[desired_pos (3), desired_ori (3x3, row-major)] in the world frame, gains
(B, 12) = [kp (6), kd (6)].
JOINT_POSITION: goal (B, na) = goal_qpos, gains (B, 2 na) = [kp, kd].
grip (B, ng) = gripper actuator ctrl.
"""

from __future__ import annotations

import functools

import torch

from robosuite_tpu_torch.controllers.parts import joint_pos as jp_mod
from robosuite_tpu_torch.controllers.parts import osc as osc_mod
from robosuite_tpu_torch.models import spec as S
from robosuite_tpu_torch.ops import build as _b
from robosuite_tpu_torch.ops import contact_solve, tables, tangent
from robosuite_tpu_torch.ops.forward import forward_plain, model_tables
from robosuite_tpu_torch.physics import contact as C
from robosuite_tpu_torch.physics import engine, kinematics
from robosuite_tpu_torch.physics.state import State
from robosuite_tpu_torch.robots.robot import FixedBaseRobot, MobileRobot


class UnsupportedFused(Exception):
    """A world/controller combination the fused substep does not cover."""


# the pair types the reference's fused substep takes
# (robosuite_tpu/ops/pallas_substep.py _SUPPORTED_PAIR_TYPES): a world with
# another (a mesh) runs unfused there and here
FUSED_PAIR_TYPES = {
    (S.PLANE, S.SPHERE), (S.PLANE, S.CAPSULE), (S.PLANE, S.CYLINDER),
    (S.PLANE, S.BOX), (S.SPHERE, S.SPHERE), (S.SPHERE, S.CAPSULE),
    (S.SPHERE, S.CYLINDER), (S.SPHERE, S.BOX), (S.CAPSULE, S.CAPSULE),
    (S.CAPSULE, S.CYLINDER), (S.CYLINDER, S.CYLINDER), (S.CAPSULE, S.BOX),
    (S.CYLINDER, S.BOX), (S.BOX, S.BOX),
}


def extract_spec(env, model) -> dict:
    """Validate that the fused substep covers (env, model) and return the
    arm's static data (robosuite_tpu/ops/pallas_substep.py extract_spec).
    Raises UnsupportedFused where the reference's gate refuses (it runs
    unfused there, and the env here), and ValueError or NotImplementedError
    where the reference fuses but the kernel cannot, so that such a world
    fails loudly and never steps the plain path on the card. As the
    reference's, it takes OSC (any setting) and JOINT_POSITION arms and
    refuses JOINT_VELOCITY, JOINT_TORQUE and IK_POSE; the OSC law's
    uncouple_pos_ori and the torque compensation come from the config.
    Tendons and equality constraints are refused first, then a mobile or
    legged robot and a WHOLE_BODY_IK composite, with the reference's
    reasons (pallas_substep.py:117-124)."""
    if model.ntendon:
        raise UnsupportedFused("tendons")
    if model.neq:
        raise UnsupportedFused("equality constraints")
    if len(env.robots) != 1 or not isinstance(env.robots[0], FixedBaseRobot):
        raise UnsupportedFused("one fixed-base robot only")
    robot = env.robots[0]
    if isinstance(robot, MobileRobot):
        raise UnsupportedFused("non-fixed-base robot")
    if robot.wbik_spec is not None:
        raise UnsupportedFused("WBIK composite")
    if len(robot.arms) != 1:
        raise UnsupportedFused("multi-arm")  # Baxter, as the reference's gate
    arm = robot.arms[0]
    cfg = robot.arm_cfg[arm]
    if isinstance(cfg, osc_mod.OSCConfig):
        ctrl_type = "osc"
    elif isinstance(cfg, jp_mod.JointPosConfig):
        ctrl_type = "joint_pos"
    else:
        raise UnsupportedFused(f"arm controller {type(cfg).__name__}")
    if C.uses_row_compaction(model):
        # the kernel solves the static row layout (pallas_substep.py:139-145)
        raise UnsupportedFused("the world compacts its contact rows")
    for key in C.pair_groups(model):
        if key not in FUSED_PAIR_TYPES:
            raise UnsupportedFused(f"pair type {key}")
    # raises ValueError above the kernels' maxima, and NotImplementedError on
    # a pair type the reference fuses but csrc/narrowphase.cuh lacks
    tables.check_model(model)
    lo, hi = robot.torque_limits[arm]
    return dict(
        qv_idx=[int(i) for i in robot.arm_qvel_idx[arm]],
        qp_idx=[int(i) for i in robot.arm_qpos_idx[arm]],
        eef_site=int(robot.eef_site_id[arm]),
        center_site=int(robot.center_site_id[arm]),
        actuator_ids=[int(a) for a in robot.arm_actuator_ids[arm]],
        torque_lo=[float(x) for x in lo],
        torque_hi=[float(x) for x in hi],
        initial_joint=[float(x) for x in robot.initial_joint[arm].cpu()],
        uncouple=bool(getattr(cfg, "uncouple_pos_ori", True)),
        grip_actuators=[int(a) for a in robot.gripper_actuator_ids[arm]],
        ctrl_type=ctrl_type,
        use_torque_compensation=bool(getattr(cfg, "use_torque_compensation", True)),
        raw_pd=bool(getattr(cfg, "raw_pd", False)),
        # the row widths of the goal and gains inputs (module docstring)
        goal_width=12 if ctrl_type == "osc" else len(robot.arm_qvel_idx[arm]),
        gains_width=12 if ctrl_type == "osc" else 2 * len(robot.arm_qvel_idx[arm]),
    )


def substep_plain(env, model, qpos, qvel, mass, inertia, gravity, armature, goal, gains, grip):
    """The plain PyTorch substep: -> (qpos', qvel', f)."""
    robot = env.robots[0]
    arm = robot.arms[0]
    B = qpos.shape[0]
    kin, M, bias = forward_plain(model, qpos, qvel, mass, inertia, gravity, armature)
    view = robot.arm_view(kin, M, bias, qpos, qvel, arm)
    cfg = robot.arm_cfg[arm]
    if isinstance(cfg, jp_mod.JointPosConfig):
        na = goal.shape[1]
        tau = jp_mod.run(cfg, jp_mod.JointPosState(goal_qpos=goal, kp=gains[:, :na], kd=gains[:, na:]), view)
    else:
        tau = osc_mod.run_world(cfg, view, goal[:, :3], goal[:, 3:].reshape(B, 3, 3), gains[:, :6], gains[:, 6:])
    lo, hi = (torch.as_tensor(x, device=tau.device) for x in robot.torque_limits[arm])
    ctrl = torch.zeros(B, model.nu, dtype=qpos.dtype, device=qpos.device)
    ctrl[:, robot.arm_actuator_ids[arm]] = torch.clamp(tau, lo, hi)
    ctrl[:, robot.gripper_actuator_ids[arm]] = grip
    state = State(qpos=qpos, qvel=qvel, time=torch.zeros(B, dtype=qpos.dtype, device=qpos.device))
    new, f = engine.integrate(model, state, ctrl, kin, M, bias, solve=contact_solve.vel_update_plain)
    return new.qpos, new.qvel, f


def substep_aux_plain(env, model, qpos, qvel, mass, inertia, gravity, armature, goal, gains, grip):
    """The plain emit_aux substep (the JAX _xla with emit_aux): ->
    (qpos', qvel', f, site_xpos', site_xmat', xpos', pair_dist'), the poses
    and per-pair minimum distances at the integrated qpos."""
    qpos2, qvel2, f = substep_plain(env, model, qpos, qvel, mass, inertia, gravity, armature, goal, gains, grip)
    kin2 = kinematics.fk(model, qpos2)
    return qpos2, qvel2, f, kin2.site_xpos, kin2.site_xmat, kin2.xpos, C.pair_min_dists(model, kin2)


def make_fused_substep(env, model, emit_aux=False):
    """fused(qpos, qvel, mass, inertia, gravity, armature, goal, gains, grip)
    -> (qpos', qvel', f), with emit_aux -> (qpos', qvel', f, site_xpos',
    site_xmat', xpos', pair_dist'). Raises as extract_spec does. Kernel
    launches of every returned wrapper count in make_fused_substep.launches
    (emit_aux: make_fused_substep.aux_launches)."""
    spec = extract_spec(env, model)
    ntot = 3 * sum(len(r) for r in C.contact_row_layout(model).values())
    ng, n_goal, n_gains = len(spec["grip_actuators"]), spec["goal_width"], spec["gains_width"]
    plain = substep_aux_plain if emit_aux else substep_plain

    def launch(qpos, qvel, mass, inertia, gravity, armature, goal, gains, grip):
        lib = _b.library()
        B = qpos.shape[0]
        for t, shape, name in ((qpos, (B, model.nq), "qpos"), (qvel, (B, model.nv), "qvel"),
                               (mass, (B, model.nbody), "mass"), (inertia, (B, model.nbody, 3), "inertia"),
                               (gravity, (B, 3), "gravity"), (armature, (B, model.nv), "armature"),
                               (goal, (B, n_goal), "goal"), (gains, (B, n_gains), "gains"), (grip, (B, ng), "grip")):
            _b.require(t, shape, name)
        T, T_host = model_tables(model, arm=spec, key="fused")
        qpos_out, qvel_out = torch.empty_like(qpos), torch.empty_like(qvel)
        f = torch.empty(B, ntot, dtype=qpos.dtype, device=qpos.device)
        ins = (qpos, qvel, mass, inertia, gravity, armature, goal, gains, grip, qpos_out, qvel_out, f)
        if not emit_aux:
            err = lib.rs_substep(_b.ptr(T), _b.ptr(T_host), *(_b.ptr(t) for t in ins), B, _b.stream())
            _b.check(err, "rs_substep")
            make_fused_substep.launches += 1
            return qpos_out, qvel_out, f
        aux = tuple(torch.empty(shape, dtype=qpos.dtype, device=qpos.device) for shape in (
            (B, model.nsite, 3), (B, model.nsite, 3, 3), (B, model.nbody, 3), (B, model.npair)))
        err = lib.rs_substep_aux(_b.ptr(T), _b.ptr(T_host), *(_b.ptr(t) for t in ins + aux), B, _b.stream())
        _b.check(err, "rs_substep_aux")
        make_fused_substep.aux_launches += 1
        return (qpos_out, qvel_out, f) + aux

    def fused(*args):
        if args[0].device.type == "cpu":
            return plain(env, model, *args)
        if tangent.carries_derivative(*args):
            return K3Function.apply(launch, functools.partial(plain, env, model), make_fused_substep, *args)
        return launch(*args)

    fused.launch = launch  # the direct launch, for the tangent checks
    fused.model, fused.spec, fused.emit_aux = model, spec, emit_aux
    return fused


class K3Function(tangent.KernelFunction):
    """K3 with its tangent rule (pallas_substep.py _sub_jvp), both laws and
    both variants: apply(primal, plain, counter, qpos, qvel, mass, inertia,
    gravity, armature, goal, gains, grip) -> the fused wrapper's outputs;
    plain `substep_plain` or `substep_aux_plain`."""


def resident_per_sm(fused) -> int:
    """Scenarios resident per SM of a fused wrapper's kernel at its model's
    carve and the library's scenarios per block (the card's occupancy
    calculator)."""
    _, T_host = model_tables(fused.model, arm=fused.spec, key="fused")
    n = _b.library().rs_substep_resident(_b.ptr(T_host), int(fused.emit_aux))
    _b.check(max(0, -n), "rs_substep_resident")
    return n


def smem_bytes(fused) -> int:
    """Shared memory per scenario of a fused wrapper's kernel (the carve
    of its model, csrc/substep.cuh carve_substep)."""
    _, T_host = model_tables(fused.model, arm=fused.spec, key="fused")
    return _b.library().rs_substep_smem_bytes(_b.ptr(T_host))


make_fused_substep.launches = 0
make_fused_substep.aux_launches = 0
make_fused_substep.tangent_passes = 0  # K3Function's derivative passes (plain version)
