"""The physics engine: smooth forces, the constrained velocity update and
semi-implicit integration, on batched tensors (the JAX package's
physics/engine.py; MuJoCo mj_step's Euler scheme with implicit joint
damping: (M + dt diag(D)) dv = dt qfrc, then positions from the new
velocities, quaternion exponential for free joints).
"""

from __future__ import annotations

import torch

from robosuite_tpu_torch.models import spec as S
from robosuite_tpu_torch.ops import contact_solve, linalg
from robosuite_tpu_torch.ops.forward import forward_products  # noqa: F401  (engine.forward_products)
from robosuite_tpu_torch.physics import contact as C
from robosuite_tpu_torch.physics import dynamics, equality
from robosuite_tpu_torch.physics.state import State
from robosuite_tpu_torch.utils import transforms as T


def actuator_forces(model, qpos, qvel, ctrl):
    """Actuator controls -> generalized forces (joint or fixed-tendon
    transmission, gear; motor / position / velocity gain models and
    `general`'s fixed gain with an affine bias, XArm7's tendon servo; ctrl
    and force limits)."""
    c = torch.where(model.actuator_ctrllimited > 0,
                    torch.clamp(ctrl, model.actuator_ctrlrange[:, 0], model.actuator_ctrlrange[:, 1]), ctrl)
    rows = model.derived("actuators", lambda: _actuator_rows(model))
    gear, g = model.actuator_gear, model.actuator_gainprm
    # the transmission's length and velocity, in actuator units
    length, velocity = gear * qpos[:, rows["qadr"]], gear * qvel[:, rows["dadr"]]
    if rows["is_ten"] is not None:
        ten = rows["is_ten"] > 0
        length = torch.where(ten, gear * (qpos @ model.ten_Jq.T)[:, rows["tid"]], length)
        velocity = torch.where(ten, gear * (qvel @ model.ten_J.T)[:, rows["tid"]], velocity)
    force = rows["motor"] * c + rows["position"] * g * (c - length) + rows["velocity"] * g * (c - velocity)
    if rows["general"] is not None:
        b = model.actuator_biasprm
        force = force + rows["general"] * (g * c + b[:, 0] + b[:, 1] * length + b[:, 2] * velocity)
    force = torch.where(model.actuator_forcelimited > 0,
                        torch.clamp(force, model.actuator_forcerange[:, 0], model.actuator_forcerange[:, 1]), force)
    if rows["is_ten"] is None:
        return torch.zeros_like(qvel).index_add(1, rows["dadr"], gear * force)
    # joint actuators straight onto their dofs, tendon ones through the
    # tendon's constant moment row (J^T f)
    qfrc = torch.zeros_like(qvel).index_add(1, rows["dadr"], (1.0 - rows["is_ten"]) * gear * force)
    return qfrc + (gear * force) @ (rows["is_ten"][:, None] * model.ten_J[rows["tid"]])


def _actuator_rows(model):
    """Each actuator's dof and qpos addresses (0 for a tendon actuator), its
    tendon (0 for a joint one), and 0-1 flags of its kind and of a tendon
    transmission (None where no actuator is general or on a tendon), on the
    model's device."""
    dev, dt, kinds = model.device, model.qpos0.dtype, model.actuator_kind
    flag = lambda v: torch.tensor(v, dtype=dt, device=dev)  # noqa: E731
    index = lambda v: torch.tensor(v, dtype=torch.long, device=dev)  # noqa: E731
    jids, tids = model.actuator_jntid, model.actuator_tenid
    out = {kind: flag([k == kind for k in kinds]) for kind in ("motor", "position", "velocity")}
    out["general"] = flag([k == "general" for k in kinds]) if "general" in kinds else None
    out["is_ten"] = flag([t >= 0 for t in tids]) if any(t >= 0 for t in tids) else None
    out["tid"] = index([max(t, 0) for t in tids])
    out["dadr"] = index([model.jnt_dofadr[j] if j >= 0 else 0 for j in jids])
    out["qadr"] = index([model.jnt_qposadr[j] if j >= 0 else 0 for j in jids])
    return out


def total_smooth_force(model, qpos, qvel, ctrl, M, bias):
    """-> (qfrc_smooth, extra_damping); the extra damping is the active
    joint- and tendon-limit damping and the tendon damping, folded into the
    implicit velocity solve."""
    qfrc_act = actuator_forces(model, qpos, qvel, ctrl)
    qfrc_spring = dynamics.passive_forces(model, qpos, qvel)
    Mdiag = torch.diagonal(M, dim1=1, dim2=2)
    qfrc_limit, extra_damp = dynamics.joint_limit_forces(model, qpos, Mdiag)
    # smooth dry-friction loss (tanh regularised)
    qfrc_fric = -model.dof_frictionloss * torch.tanh(qvel / 0.005)
    total = qfrc_act + qfrc_spring + qfrc_limit + qfrc_fric - bias
    if model.ntendon:
        qfrc_ten, ten_damp = dynamics.tendon_forces(model, qpos, qvel, Mdiag)
        total, extra_damp = total + qfrc_ten, extra_damp + ten_damp
    return total, extra_damp


def integrate_qpos(model, qpos, qvel_new, dt):
    """Position update with the new velocities (MuJoCo mj_integratePos)."""
    out = qpos.clone()
    qadr, dadr, _ = dynamics.scalar_joint_tensors(model)
    out[:, qadr] = out[:, qadr] + dt * qvel_new[:, dadr]
    for j in range(model.njnt):
        qa, da = model.jnt_qposadr[j], model.jnt_dofadr[j]
        # read from qpos, not out: a view of out written in place would
        # break a reverse-mode graph through the quaternion product
        if model.jnt_type[j] == S.FREE:
            out[:, qa:qa + 3] = qpos[:, qa:qa + 3] + dt * qvel_new[:, da:da + 3]
            out[:, qa + 3:qa + 7] = T.quat_integrate_wxyz(qpos[:, qa + 3:qa + 7], qvel_new[:, da + 3:da + 6], dt)
        elif model.jnt_type[j] == S.BALL:
            out[:, qa:qa + 4] = T.quat_integrate_wxyz(qpos[:, qa:qa + 4], qvel_new[:, da:da + 3], dt)
    return out


def integrate(model, state: State, ctrl, kin, M, bias, solve=contact_solve.vel_update):
    """mj_step2: forces + contacts + semi-implicit integration, given the
    forward products. `solve` is the velocity update (the K2 wrapper, or
    its plain version). Returns (state', solver forces f)."""
    dt = model.timestep
    qfrc_smooth, extra_damp = total_smooth_force(model, state.qpos, state.qvel, ctrl, M, bias)
    damping = (model.dof_damping + extra_damp).contiguous()
    if model.npair == 0:
        qvel_new, f = pairless_update(model, kin, state, M, qfrc_smooth, damping, dt)
        return State(qpos=integrate_qpos(model, state.qpos, qvel_new, dt), qvel=qvel_new, time=state.time + dt), f
    JfT, aref, reg3, mu, active = C.contact_rows(model, kin, state.qvel, dt, state.qpos)
    qvel_new, f = solve(M.contiguous(), JfT, aref.contiguous(), qfrc_smooth.contiguous(), state.qvel.contiguous(),
                        damping, reg3.contiguous(), mu, active.contiguous(), *C.solver_iterations(model), dt)
    qpos_new = integrate_qpos(model, state.qpos, qvel_new, dt)
    return State(qpos=qpos_new, qvel=qvel_new, time=state.time + dt), f


def pairless_update(model, kin, state: State, M, qfrc_smooth, damping, dt):
    """The velocity update of a world with no contact pair (the JAX
    engine's con None branches): unconstrained, or with equality rows
    only, their forces f = (A + diag(0.05 max(diag A, 1e-8)))^-1 (aref -
    J qacc_smooth), A = J M^-1 J^T, solved directly. -> (qvel', f)."""
    qvel = state.qvel
    eq = equality.equality_rows(model, kin, state.qpos, qvel)
    Mh = M + dt * torch.diag_embed(damping)
    if eq is None:
        return qvel + dt * linalg.solve_spd(Mh, qfrc_smooth - damping * qvel), qvel.new_zeros(qvel.shape[0], 0)
    J, aref = eq
    Lm = linalg.chol_factor(M)
    qacc_smooth = linalg.chol_solve(Lm, qfrc_smooth - damping * qvel)
    A = J @ linalg.chol_solve(Lm, J.transpose(1, 2))
    reg = 0.05 * torch.clamp_min(torch.diagonal(A, dim1=1, dim2=2), 1e-8)
    f = linalg.solve_spd(A + torch.diag_embed(reg), aref - (J @ qacc_smooth[..., None])[..., 0])
    qfrc_con = (J.transpose(1, 2) @ f[..., None])[..., 0]
    return qvel + dt * linalg.solve_spd(Mh, qfrc_smooth + qfrc_con - damping * qvel), f


def step(model, state: State, ctrl):
    """One physics substep at model.timestep (mj_step)."""
    kin, M, bias = forward_products(model, state.qpos, state.qvel)
    return integrate(model, state, ctrl, kin, M, bias)[0]


def step_n(model, state: State, ctrl, n: int) -> State:
    """n substeps under one ctrl."""
    for _ in range(n):
        state = step(model, state, ctrl)
    return state
