"""Carry a world and a state across from the JAX package as numpy arrays,
so that both packages compute on the identical model and state (the
port's tests use this; nothing here imports JAX).

    leaves = {name: np.asarray(getattr(jax_model, name)) for name in model.LEAVES}
    meta = {name: getattr(jax_model, name) for name in model.STATIC}
    port_model = model_from_numpy(leaves, meta, device="cpu")

Every function allocates on CUDA unless the caller passes device="cpu"
(or another device).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from robosuite_tpu_torch.controllers.parts.joint_pos import JointPosState
from robosuite_tpu_torch.controllers.parts.osc import OSCState
from robosuite_tpu_torch.envs.base import EnvState
from robosuite_tpu_torch.models.model import Model
from robosuite_tpu_torch.mpc.receding import MPCState
from robosuite_tpu_torch.physics.state import State
from robosuite_tpu_torch.robots.robot import RobotCtrlState


def model_from_numpy(leaves: Dict[str, np.ndarray], meta: dict, device="cuda") -> Model:
    """The port's Model from the JAX Model's leaves (numpy) and static
    fields (models.model.LEAVES / STATIC name them)."""
    return Model(leaves, meta).to(device)


def state_from_numpy(qpos, qvel, ctrl_leaves: Dict[str, np.ndarray], arm="right", device="cuda") -> EnvState:
    """A batched EnvState from numpy qpos (B, nq), qvel (B, nv) and the
    controller leaves, keyed by the arm controller they belong to: OSC
    goal_pos (B, 3), goal_ori (B, 3, 3), kp (B, 6), kd (B, 6), or
    JOINT_POSITION goal_qpos (B, na), kp (B, na), kd (B, na); and
    gripper_action (B, n)."""
    def t(x):
        return torch.tensor(np.array(x, dtype=np.float32), device=device)

    qpos, qvel = t(qpos), t(qvel)
    cls = JointPosState if "goal_qpos" in ctrl_leaves else OSCState
    arm_state = cls(**{f.name: t(ctrl_leaves[f.name]) for f in dataclasses.fields(cls)})
    ctrl = RobotCtrlState(arm={arm: arm_state}, gripper_action={arm: t(ctrl_leaves["gripper_action"])})
    B = qpos.shape[0]
    return EnvState(physics=State(qpos=qpos, qvel=qvel, time=torch.zeros(B, device=device)), ctrl=ctrl,
                    t=torch.zeros(B, dtype=torch.int32, device=device))


def mpc_state_from_numpy(us, fxs=None, fus=None, tick=None, generator=None, device="cuda") -> MPCState:
    """A batched MPCState from numpy plans us (B, H, A) and, for the RTI
    carry, fxs (B, H, nx, nx), fus (B, H, nx, A) and tick (B,) (lock-stepped:
    its host mirror is tick[0])."""
    def t(x, dtype=torch.float32):
        return None if x is None else torch.tensor(np.array(x), dtype=dtype, device=device)

    tick_t = t(tick, torch.int32)
    return MPCState(us=t(us), generator=generator, fxs=t(fxs), fus=t(fus), tick=tick_t,
                    tick_host=0 if tick_t is None else int(tick_t[0]))
