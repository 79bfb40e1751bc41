"""Stack: stack the red cube (A) on the green cube (B) (the JAX package's
envs/stack.py; robosuite environments/manipulation/stack.py: model
(:313-400), staged rewards (:224-312), success (:485-493))."""

from __future__ import annotations

import numpy as np
import torch

from robosuite_tpu_torch.envs.base import RobotEnv, register_env
from robosuite_tpu_torch.models.arenas import TableArena
from robosuite_tpu_torch.models.objects import BoxObject
from robosuite_tpu_torch.models.tasks import ManipulationTask
from robosuite_tpu_torch.utils import transforms as T
from robosuite_tpu_torch.utils.placement import PlacementSpec, sample_placements


@register_env
class Stack(RobotEnv):
    def __init__(self, robots="Panda", table_full_size=(0.8, 0.8, 0.05), table_friction=(1.0, 0.005, 0.0001),
                 reward_scale=1.0, reward_shaping=False, **kwargs):
        self.table_full_size = np.array(table_full_size)
        self.table_friction = table_friction
        self.table_offset = np.array((0, 0, 0.8))
        super().__init__(robots=robots, reward_scale=reward_scale, reward_shaping=reward_shaping, **kwargs)

    def _load_model(self):
        rm = self.robot_models[0]
        rm.set_base_xpos(rm.base_xpos_offset["table"](self.table_full_size[0]))
        arena = TableArena(table_full_size=self.table_full_size, table_friction=self.table_friction,
                           table_offset=self.table_offset)
        arena.set_origin([0, 0, 0])
        # robosuite stack.py:355-370: fixed sizes
        self.cubeA = BoxObject(name="cubeA", size=[0.02, 0.02, 0.02], rgba=[1, 0, 0, 1])
        self.cubeB = BoxObject(name="cubeB", size=[0.025, 0.025, 0.025], rgba=[0, 1, 0, 1])
        self.task = ManipulationTask(arena, self.robot_models, [self.cubeA, self.cubeB])

    def _setup_references(self):
        m = self.model
        self.cubeA_body_id = m.body_name2id(self.cubeA.root_body)
        self.cubeB_body_id = m.body_name2id(self.cubeB.root_body)
        self.table_top_z = float(self.table_offset[2])
        self.eef_site = self.robots[0].eef_site_id["right"]
        self._graspA_pairs = self.grasp_pairs("right", self.cubeA.contact_geoms)
        self._touchAB_pairs = self._contact_pairs(self.cubeA.contact_geoms, self.cubeB.contact_geoms)
        self._placements = [
            PlacementSpec(name=obj.name, qpos_start=m.jnt_qpos_slice(f"{obj.name}_joint0").start,
                          x_range=(-0.08, 0.08), y_range=(-0.08, 0.08), rotation=None,
                          reference_pos=tuple(float(x) for x in self.table_offset), z_offset=0.01,
                          bottom_offset=float(obj.bottom_offset[2]), horizontal_radius=obj.horizontal_radius)
            for obj in (self.cubeA, self.cubeB)
        ]

    def _sample_placements(self, generator, n):
        return sample_placements(self._placements, n, generator)

    def _staged_rewards(self, kin):
        """robosuite stack.py:268-312: (reach, lift, stack), each (B,)."""
        cubeA_pos = kin.xpos[:, self.cubeA_body_id]
        cubeB_pos = kin.xpos[:, self.cubeB_body_id]
        dist = torch.linalg.vector_norm(kin.site_xpos[:, self.eef_site] - cubeA_pos, dim=-1)
        grasping = self.check_grasp(kin, *self._graspA_pairs)
        r_reach = (1.0 - torch.tanh(10.0 * dist)) * 0.25 + torch.where(grasping, 0.25, 0.0)
        lifted = cubeA_pos[:, 2] > self.table_top_z + 0.04
        horiz = torch.linalg.vector_norm(cubeA_pos[:, :2] - cubeB_pos[:, :2], dim=-1)
        r_lift = torch.where(lifted, 1.0 + 0.5 * (1.0 - torch.tanh(horiz)), torch.zeros_like(horiz))
        touching = self._any_contact(kin, self._touchAB_pairs)
        r_stack = torch.where((~grasping) & (r_lift > 0) & touching, 2.0, 0.0)
        return r_reach, r_lift, r_stack

    def _check_success(self, kin):
        return self._staged_rewards(kin)[2] > 0

    def reward(self, physics, kin):
        """robosuite stack.py:224-267 (shaped: the best staged reward; sparse:
        2 on success), scaled by reward_scale / 2."""
        r_reach, r_lift, r_stack = self._staged_rewards(kin)
        if self.reward_shaping:
            r = torch.maximum(torch.maximum(r_reach, r_lift), r_stack)
        else:
            r = torch.where(r_stack > 0, 2.0, 0.0)
        if self.reward_scale is not None:
            r = r * self.reward_scale / 2.0
        return r

    def _get_observations(self, physics, kin):
        """The raw Stack observation dict (robosuite stack.py:402-483 + the
        robot's proprioception), batched."""
        robot = self.robots[0]
        qp = physics.qpos[:, robot.arm_qpos_idx["right"]]
        qv = physics.qvel[:, robot.arm_qvel_idx["right"]]
        eef_pos = kin.site_xpos[:, self.eef_site]
        a_pos = kin.xpos[:, self.cubeA_body_id]
        b_pos = kin.xpos[:, self.cubeB_body_id]
        return {
            "robot0_joint_pos": qp,
            "robot0_joint_pos_cos": torch.cos(qp),
            "robot0_joint_pos_sin": torch.sin(qp),
            "robot0_joint_vel": qv,
            "robot0_eef_pos": eef_pos,
            "robot0_eef_quat": T.mat2quat(kin.site_xmat[:, self.eef_site]),
            "robot0_gripper_qpos": physics.qpos[:, robot.gripper_joint_qpos_idx["right"]],
            "robot0_gripper_qvel": physics.qvel[:, robot.gripper_joint_qvel_idx["right"]],
            "cubeA_pos": a_pos,
            "cubeA_quat": T.convert_quat(kin.xquat[:, self.cubeA_body_id], to="xyzw"),
            "cubeB_pos": b_pos,
            "cubeB_quat": T.convert_quat(kin.xquat[:, self.cubeB_body_id], to="xyzw"),
            "cubeA_to_cubeB": b_pos - a_pos,
            "gripper_to_cubeA": a_pos - eef_pos,
            "gripper_to_cubeB": b_pos - eef_pos,
        }
