"""The physics engine: smooth forces, the constrained velocity update and
semi-implicit integration, on batched tensors (the JAX package's
physics/engine.py; MuJoCo mj_step's Euler scheme with implicit joint
damping: (M + dt diag(D)) dv = dt qfrc, then positions from the new
velocities, quaternion exponential for free joints).
"""

from __future__ import annotations

import torch

from robosuite_tpu_torch.models import spec as S
from robosuite_tpu_torch.ops import contact_solve
from robosuite_tpu_torch.ops.forward import forward_products  # noqa: F401  (engine.forward_products)
from robosuite_tpu_torch.physics import contact as C
from robosuite_tpu_torch.physics import dynamics
from robosuite_tpu_torch.physics.state import State
from robosuite_tpu_torch.utils import transforms as T


def actuator_forces(model, qpos, qvel, ctrl):
    """Actuator controls -> generalized forces (joint transmission, gear;
    motor / position / velocity gain models; ctrl and force limits)."""
    c = torch.where(model.actuator_ctrllimited > 0,
                    torch.clamp(ctrl, model.actuator_ctrlrange[:, 0], model.actuator_ctrlrange[:, 1]), ctrl)
    dadr, qadr, is_pos, is_vel, is_motor = model.derived("actuators", lambda: _actuator_rows(model))
    gear, g = model.actuator_gear, model.actuator_gainprm
    force = (is_motor * c + is_pos * g * (c - gear * qpos[:, qadr]) + is_vel * g * (c - gear * qvel[:, dadr]))
    force = torch.where(model.actuator_forcelimited > 0,
                        torch.clamp(force, model.actuator_forcerange[:, 0], model.actuator_forcerange[:, 1]), force)
    return torch.zeros_like(qvel).index_add(1, dadr, gear * force)


def _actuator_rows(model):
    """(dof address, qpos address, position / velocity / motor 0-1 flags)
    of each actuator, on the model's device."""
    dev, dt, kinds = model.device, model.qpos0.dtype, model.actuator_kind
    flag = lambda kind: torch.tensor([k == kind for k in kinds], dtype=dt, device=dev)  # noqa: E731
    return (torch.tensor([model.jnt_dofadr[j] for j in model.actuator_jntid], dtype=torch.long, device=dev),
            torch.tensor([model.jnt_qposadr[j] for j in model.actuator_jntid], dtype=torch.long, device=dev),
            flag("position"), flag("velocity"), flag("motor"))


def total_smooth_force(model, qpos, qvel, ctrl, M, bias):
    """-> (qfrc_smooth, extra_damping); the extra damping is the active
    joint-limit damping, folded into the implicit velocity solve."""
    qfrc_act = actuator_forces(model, qpos, qvel, ctrl)
    qfrc_spring = dynamics.passive_forces(model, qpos, qvel)
    qfrc_limit, extra_damp = dynamics.joint_limit_forces(model, qpos, torch.diagonal(M, dim1=1, dim2=2))
    # smooth dry-friction loss (tanh regularised)
    qfrc_fric = -model.dof_frictionloss * torch.tanh(qvel / 0.005)
    return qfrc_act + qfrc_spring + qfrc_limit + qfrc_fric - bias, extra_damp


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
    JfT, aref, reg3, mu, active = C.contact_rows(model, kin, state.qvel, dt)
    damping = (model.dof_damping + extra_damp).contiguous()
    qvel_new, f = solve(M.contiguous(), JfT, aref.contiguous(), qfrc_smooth.contiguous(), state.qvel.contiguous(),
                        damping, reg3.contiguous(), mu, active.contiguous(), *C.solver_iterations(model), dt)
    qpos_new = integrate_qpos(model, state.qpos, qvel_new, dt)
    return State(qpos=qpos_new, qvel=qvel_new, time=state.time + dt), f


def step(model, state: State, ctrl):
    """One physics substep at model.timestep (mj_step)."""
    kin, M, bias = forward_products(model, state.qpos, state.qvel)
    return integrate(model, state, ctrl, kin, M, bias)[0]


def step_n(model, state: State, ctrl, n: int) -> State:
    """n substeps under one ctrl."""
    for _ in range(n):
        state = step(model, state, ctrl)
    return state
