"""Door: open a door by its handle (the JAX package's envs/door.py;
robosuite environments/manipulation/door.py: model (:270-325), reward
(:219-266), success hinge_qpos > 0.3 (:426-433)).

robosuite randomizes the door's body pose at reset by editing the
compiled model (door.py:420-423). Here, as in the JAX package, the pose is
drawn once at construction from np.random.default_rng(seed), in the JAX
class's order, so one seed gives both packages the same world.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from robosuite_tpu_torch.envs.base import RobotEnv, register_env
from robosuite_tpu_torch.models.arenas import TableArena
from robosuite_tpu_torch.models.objects.xml_objects import DoorObject
from robosuite_tpu_torch.models.tasks import ManipulationTask
from robosuite_tpu_torch.utils import transforms as T


@register_env
class Door(RobotEnv):
    def __init__(self, robots="Panda", use_latch=True, reward_scale=1.0, reward_shaping=False, seed=None, **kwargs):
        self.use_latch = use_latch
        self.table_full_size = (0.8, 0.3, 0.05)
        self.table_offset = np.array((-0.2, -0.35, 0.8))
        self._model_rng = np.random.default_rng(seed)
        super().__init__(robots=robots, reward_scale=reward_scale, reward_shaping=reward_shaping, **kwargs)

    def _load_model(self):
        rm = self.robot_models[0]
        rm.set_base_xpos(rm.base_xpos_offset["table"](self.table_full_size[0]))
        arena = TableArena(table_full_size=self.table_full_size, table_offset=self.table_offset)
        self.door = DoorObject(name="Door", friction=0.0, damping=0.1, lock=self.use_latch)
        root = self.door.get_obj()
        # x in [0.07, 0.09], y in [-0.01, 0.01], z rotation in [-pi/2 - 0.25,
        # -pi/2], relative to the table (robosuite door.py:306-318)
        x = self._model_rng.uniform(0.07, 0.09) + self.table_offset[0]
        y = self._model_rng.uniform(-0.01, 0.01) + self.table_offset[1]
        rot = self._model_rng.uniform(-np.pi / 2.0 - 0.25, -np.pi / 2.0)
        root.pos = np.array([x, y, self.table_offset[2] + 0.3])
        root.quat = np.array([np.cos(rot / 2), 0.0, 0.0, np.sin(rot / 2)])
        self.task = ManipulationTask(arena, self.robot_models, self.door)

    def _setup_references(self):
        m = self.model
        self.door_body_id = m.body_name2id(self.door.door_body)
        self.handle_site_id = m.site_name2id(self.door.important_sites["handle"])
        self.hinge_qpos_addr = m.jnt_qpos_slice(self.door.hinge_joint).start
        if self.use_latch:
            self.handle_qpos_addr = m.jnt_qpos_slice(self.door.latch_joint).start
        self.eef_site = self.robots[0].eef_site_id["right"]

    def _check_success(self, physics):
        return physics.qpos[:, self.hinge_qpos_addr] > 0.3

    def reward(self, physics, kin):
        """robosuite door.py:219-266: shaped, reaching the handle (0.25) plus
        turning the latch (0.25); 1 on success; scaled by reward_scale."""
        success = self._check_success(physics)
        one = torch.ones_like(physics.qpos[:, 0])
        if self.reward_shaping:
            dist = torch.linalg.vector_norm(kin.site_xpos[:, self.handle_site_id] - kin.site_xpos[:, self.eef_site],
                                            dim=-1)
            r = 0.25 * (1.0 - torch.tanh(10.0 * dist))
            if self.use_latch:
                handle_qpos = physics.qpos[:, self.handle_qpos_addr]
                r = r + torch.clamp(0.25 * torch.abs(handle_qpos / (0.5 * math.pi)), -0.25, 0.25)
            r = torch.where(success, one, r)
        else:
            r = torch.where(success, one, torch.zeros_like(one))
        if self.reward_scale is not None:
            r = r * self.reward_scale / 1.0
        return r

    def _get_observations(self, physics, kin):
        """The raw Door observation dict (robosuite door.py:327-400 + the
        robot's proprioception), batched."""
        robot = self.robots[0]
        qp = physics.qpos[:, robot.arm_qpos_idx["right"]]
        qv = physics.qvel[:, robot.arm_qvel_idx["right"]]
        eef_pos = kin.site_xpos[:, self.eef_site]
        handle_pos = kin.site_xpos[:, self.handle_site_id]
        door_pos = kin.xpos[:, self.door_body_id]
        obs = {
            "robot0_joint_pos": qp,
            "robot0_joint_pos_cos": torch.cos(qp),
            "robot0_joint_pos_sin": torch.sin(qp),
            "robot0_joint_vel": qv,
            "robot0_eef_pos": eef_pos,
            "robot0_eef_quat": T.mat2quat(kin.site_xmat[:, self.eef_site]),
            "robot0_gripper_qpos": physics.qpos[:, robot.gripper_joint_qpos_idx["right"]],
            "robot0_gripper_qvel": physics.qvel[:, robot.gripper_joint_qvel_idx["right"]],
            "door_pos": door_pos,
            "handle_pos": handle_pos,
            "door_to_eef_pos": door_pos - eef_pos,
            "handle_to_eef_pos": handle_pos - eef_pos,
            "hinge_qpos": physics.qpos[:, self.hinge_qpos_addr:self.hinge_qpos_addr + 1],
        }
        if self.use_latch:
            obs["handle_qpos"] = physics.qpos[:, self.handle_qpos_addr:self.handle_qpos_addr + 1]
        return obs
