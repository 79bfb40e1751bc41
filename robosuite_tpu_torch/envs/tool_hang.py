"""ToolHang: insert the hook frame into the stand, then hang the wrench on it
(the JAX package's envs/tool_hang.py; robosuite environments/manipulation/
tool_hang.py: the sparse reward only (:217), success = the frame assembled
and the tool on the frame (:597-660)).

The stand, the hook frame and the ratcheting wrench are the composite
objects of models/objects/composite_objects.py. The world compacts its 656
candidate rows, so it steps unfused, as the JAX package's does.
"""

from __future__ import annotations

import numpy as np
import torch

from robosuite_tpu_torch.envs.base import RobotEnv, register_env
from robosuite_tpu_torch.models.arenas import TableArena
from robosuite_tpu_torch.models.objects.composite_objects import HookFrame, RatchetingWrench, StandWithMount
from robosuite_tpu_torch.models.tasks import ManipulationTask
from robosuite_tpu_torch.utils import transforms as T
from robosuite_tpu_torch.utils.placement import PlacementSpec, sample_placements

# (x range, y range) of each object's placement about the table's centre
# (tool_hang.py's placement initializer); the stand is not turned
_RANGES = {"stand": ((-0.08, -0.08), (0.16, 0.16)), "frame": ((-0.12, -0.08), (-0.22, -0.18)),
           "tool": ((-0.12, -0.08), (-0.05, 0.05))}


@register_env
class ToolHang(RobotEnv):
    def __init__(self, robots="Panda", reward_scale=1.0, reward_shaping=False, **kwargs):
        self.table_full_size = (0.8, 0.8, 0.05)
        self.table_offset = np.array((0, 0, 0.8))
        super().__init__(robots=robots, reward_scale=reward_scale, reward_shaping=reward_shaping, **kwargs)

    def _load_model(self):
        rm = self.robot_models[0]
        rm.set_base_xpos(rm.base_xpos_offset["table"](self.table_full_size[0]))
        arena = TableArena(table_full_size=self.table_full_size, table_offset=self.table_offset)
        self.stand = StandWithMount("stand")
        self.frame = HookFrame("frame")
        self.tool = RatchetingWrench("tool")
        self.task = ManipulationTask(arena, self.robot_models, [self.stand, self.frame, self.tool])

    def _setup_references(self):
        m = self.model
        self.stand_body_id = m.body_name2id(self.stand.root_body)
        self.frame_body_id = m.body_name2id(self.frame.root_body)
        self.tool_body_id = m.body_name2id(self.tool.root_body)
        self.frame_hang_site = m.site_name2id(self.frame.important_sites["hang"])
        self.frame_intersect_site = m.site_name2id(self.frame.important_sites["intersection"])
        self.tool_ring_site = m.site_name2id(self.tool.important_sites["ring"])
        self.eef_site = self.robots[0].eef_site_id["right"]
        self._placements = [PlacementSpec(
            name=obj.name, qpos_start=m.jnt_qpos_slice(f"{obj.name}_joint0").start, x_range=_RANGES[obj.name][0],
            y_range=_RANGES[obj.name][1], rotation=(0.0, 0.0) if obj is self.stand else None,
            reference_pos=tuple(self.table_offset), z_offset=0.001, bottom_offset=float(obj.bottom_offset[2]),
            horizontal_radius=obj.horizontal_radius) for obj in (self.stand, self.frame, self.tool)]

    def _sample_placements(self, generator, n):
        return sample_placements(self._placements, n, generator)

    def _check_frame_assembled(self, kin):
        """The frame upright with its intersection site within 3 cm across
        and 15 cm along z of the stand's mount top (tool_hang.py:606-655)."""
        stand_top = kin.xpos[:, self.stand_body_id] + torch.tensor([0.0, 0.0, 0.21], dtype=kin.xpos.dtype,
                                                                   device=kin.xpos.device)
        insert = kin.site_xpos[:, self.frame_intersect_site]
        upright = kin.xmat[:, self.frame_body_id, 2, 2] > 0.9
        horiz = torch.linalg.vector_norm(insert[:, :2] - stand_top[:, :2], dim=-1) < 0.03
        vert = torch.abs(insert[:, 2] - stand_top[:, 2]) < 0.15
        return upright & horiz & vert

    def _check_tool_on_frame(self, kin):
        """The wrench's ring within 3 cm across of the hook's hang site and
        hanging below it, by less than 15 cm."""
        hang = kin.site_xpos[:, self.frame_hang_site]
        ring = kin.site_xpos[:, self.tool_ring_site]
        near = torch.linalg.vector_norm(ring[:, :2] - hang[:, :2], dim=-1) < 0.03
        drop = hang[:, 2] - ring[:, 2]
        return near & (drop > 0.0) & (drop < 0.15)

    def _check_success(self, kin):
        return self._check_frame_assembled(kin) & self._check_tool_on_frame(kin)

    def reward(self, physics, kin):
        """1 on success, else 0, shaping or not (tool_hang.py:217); scaled by
        reward_scale."""
        r = self._check_success(kin).to(kin.xpos.dtype)
        if self.reward_scale is not None:
            r = r * self.reward_scale
        return r

    def _get_observations(self, physics, kin):
        robot = self.robots[0]
        qp = physics.qpos[:, robot.arm_qpos_idx["right"]]
        eef = kin.site_xpos[:, self.eef_site]
        obs = {
            "robot0_joint_pos": qp,
            "robot0_joint_pos_cos": torch.cos(qp),
            "robot0_joint_pos_sin": torch.sin(qp),
            "robot0_joint_vel": physics.qvel[:, robot.arm_qvel_idx["right"]],
            "robot0_eef_pos": eef,
            "robot0_eef_quat": T.mat2quat(kin.site_xmat[:, self.eef_site]),
            "robot0_gripper_qpos": physics.qpos[:, robot.gripper_joint_qpos_idx["right"]],
        }
        for name, bid in (("stand", self.stand_body_id), ("frame", self.frame_body_id), ("tool", self.tool_body_id)):
            obs[f"{name}_pos"] = kin.xpos[:, bid]
            obs[f"{name}_quat"] = T.convert_quat(kin.xquat[:, bid], to="xyzw")
            obs[f"{name}_to_eef"] = kin.xpos[:, bid] - eef
        return obs
