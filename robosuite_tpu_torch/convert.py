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

from robosuite_tpu_torch.controllers.parts.ik import IKState
from robosuite_tpu_torch.controllers.parts.joint_pos import JointPosState
from robosuite_tpu_torch.controllers.parts.joint_tor import JointTorState
from robosuite_tpu_torch.controllers.parts.joint_vel import JointVelState
from robosuite_tpu_torch.controllers.parts.mobile_base import MobileBaseState
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


def numpy_tree(obj):
    """A state as nested dicts of numpy arrays: each dataclass (a JAX
    EnvState, its State, RobotCtrlStates, controller and task states) a dict
    of its fields, tuples and lists lists, arrays np.asarray; None stays
    None. The tree state_from_numpy takes."""
    if obj is None:
        return None
    if dataclasses.is_dataclass(obj):
        return {f.name: numpy_tree(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: numpy_tree(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return [numpy_tree(v) for v in obj]
    return np.asarray(obj)


def state_from_numpy(qpos, qvel=None, ctrl_leaves: Dict[str, np.ndarray] = None, arm="right", device="cuda",
                     task_state_cls=None) -> EnvState:
    """A batched EnvState, from either

    - a state tree (numpy_tree of a batched JAX EnvState, of any env):
      {"physics": {"qpos", "qvel", "time"}, "ctrl": one robot's
      {"arm": {arm: controller leaves}, "gripper_action": {arm: ramp}} or
      a list of one per robot, "t", and "task_state" (a dict of the task
      state's leaves, built as `task_state_cls`, or None); other keys
      (the JAX rng, obs_cache) are not carried; or
    - numpy qpos (B, nq), qvel (B, nv) and one arm's controller leaves:
      OSC goal_pos (B, 3), goal_ori (B, 3, 3), kp (B, 6), kd (B, 6) and
      the interpolation's start_pos, start_ori (or None), or
      JOINT_POSITION goal_qpos (B, na), kp (B, na), kd (B, na); and
      gripper_action (B, n).

    The controller state's class follows its leaves: goal_qpos
    JOINT_POSITION (an arm's, or a mobile robot's torso, head or legs),
    joint IK_POSE (a JOINT_POSITION state inside), goal_vel JOINT_VELOCITY
    (saturated a bool), goal_torque JOINT_TORQUE, goal_qvel and init_yaw a
    mobile base's MobileBaseState, else OSC."""
    def t(x, dtype=torch.float32):
        return torch.tensor(np.array(x), dtype=dtype, device=device)

    def arm_state(leaves):
        if "joint" in leaves:
            return IKState(joint=arm_state(leaves["joint"]))
        cls = next((c for key, c in (("goal_qpos", JointPosState), ("goal_vel", JointVelState),
                                     ("goal_torque", JointTorState), ("init_yaw", MobileBaseState))
                    if key in leaves), OSCState)
        optional = {f.name for f in dataclasses.fields(cls) if f.default is None}  # OSC's start pose
        return cls(**{f.name: None if f.name in optional and leaves.get(f.name) is None else
                      t(leaves[f.name], torch.bool if f.name == "saturated" else torch.float32)
                      for f in dataclasses.fields(cls)})

    def robot(tree):
        return RobotCtrlState(arm={a: arm_state(v) for a, v in tree["arm"].items()},
                              gripper_action={a: t(v) for a, v in tree["gripper_action"].items()})

    if not isinstance(qpos, dict):
        leaves = dict(ctrl_leaves)
        ramp = leaves.pop("gripper_action")
        qpos = {"physics": {"qpos": qpos, "qvel": qvel}, "ctrl": {"arm": {arm: leaves}, "gripper_action": {arm: ramp}}}
    tree, phys = qpos, qpos["physics"]
    q = t(phys["qpos"])
    B = q.shape[0]
    time = t(phys["time"]) if phys.get("time") is not None else torch.zeros(B, device=device)
    ctrl = tree["ctrl"]
    ctrl = tuple(robot(c) for c in ctrl) if isinstance(ctrl, (list, tuple)) else robot(ctrl)
    steps = t(tree["t"], torch.int32) if tree.get("t") is not None else torch.zeros(B, dtype=torch.int32,
                                                                                    device=device)
    task = tree.get("task_state")
    if task is not None:
        if task_state_cls is None:
            raise ValueError("the state has a task state: pass task_state_cls (e.g. envs.wipe.WipeTaskState)")
        task = task_state_cls(**{k: torch.tensor(np.array(v), device=device) for k, v in task.items()})
    return EnvState(physics=State(qpos=q, qvel=t(phys["qvel"]), time=time), ctrl=ctrl, t=steps, task_state=task)


def mpc_state_from_numpy(us, fxs=None, fus=None, tick=None, generator=None, device="cuda") -> MPCState:
    """A batched MPCState from numpy plans us (B, H, A) and, for the RTI
    carry, fxs (B, H, nx, nx), fus (B, H, nx, A) and tick (B,) (lock-stepped:
    its host mirror is tick[0])."""
    def t(x, dtype=torch.float32):
        return None if x is None else torch.tensor(np.array(x), dtype=dtype, device=device)

    tick_t = t(tick, torch.int32)
    return MPCState(us=t(us), generator=generator, fxs=t(fxs), fus=t(fus), tick=tick_t,
                    tick_host=0 if tick_t is None else int(tick_t[0]))
