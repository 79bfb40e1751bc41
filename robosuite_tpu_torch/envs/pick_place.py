"""PickPlace: move objects from one bin to their target bins (the JAX
package's envs/pick_place.py; robosuite environments/manipulation/
pick_place.py: staged rewards (:274-401), not_in_bin (:404-425),
placement (:427-470), success (:737+), the variants Single, Milk, Bread,
Cereal and Can (:799+)).

The objects are convex hulls (models/objects/hull_objects.py); the world
has 606 candidate pairs and compacts its active contact rows
(physics/contact.py uses_row_compaction), so every substep takes the
unfused path: forward products (K1), the plain narrowphase and row
compaction, and the contact solve (K2).
"""

from __future__ import annotations

import numpy as np
import torch

from robosuite_tpu_torch.envs.base import RobotEnv, register_env
from robosuite_tpu_torch.models.arenas import BinsArena
from robosuite_tpu_torch.models.objects.hull_objects import BreadObject, CanObject, CerealObject, MilkObject
from robosuite_tpu_torch.models.tasks import ManipulationTask
from robosuite_tpu_torch.utils import transforms as T
from robosuite_tpu_torch.utils.placement import PlacementSpec, sample_placements


@register_env
class PickPlace(RobotEnv):
    def __init__(self, robots="Panda", single_object_mode=0, object_type=None, reward_scale=1.0,
                 reward_shaping=False, z_rotation=None, **kwargs):
        self.single_object_mode = single_object_mode
        self.object_to_id = {"milk": 0, "bread": 1, "cereal": 2, "can": 3}
        if object_type is not None:
            if object_type not in self.object_to_id:
                raise ValueError(f"unknown object_type {object_type!r}; known: {sorted(self.object_to_id)}")
            self.object_id = self.object_to_id[object_type]
        else:
            self.object_id = 0
        self.z_rotation = z_rotation
        self.bin1_pos = np.array((0.1, -0.25, 0.8))
        self.bin2_pos = np.array((0.1, 0.28, 0.8))
        super().__init__(robots=robots, reward_scale=reward_scale, reward_shaping=reward_shaping, **kwargs)

    def _load_model(self):
        rm = self.robot_models[0]
        rm.set_base_xpos(rm.base_xpos_offset["bins"])
        arena = BinsArena(bin1_pos=self.bin1_pos)
        self.bin_size = arena.table_full_size
        self.objects = [MilkObject("Milk"), BreadObject("Bread"), CerealObject("Cereal"), CanObject("Can")]
        self.task = ManipulationTask(arena, self.robot_models, self.objects)

    def _bin_low(self, i):
        """The low (x, y) corner of object i's quadrant of bin 2."""
        x, y = self.bin2_pos[0], self.bin2_pos[1]
        if i in (0, 2):
            x -= self.bin_size[0] / 2
        if i < 2:
            y -= self.bin_size[1] / 2
        return x, y

    def _setup_references(self):
        m = self.model
        self.obj_body_ids = [m.body_name2id(o.root_body) for o in self.objects]
        self._obj_ids = torch.tensor(self.obj_body_ids, device=self.device)
        self.eef_site = self.robots[0].eef_site_id["right"]
        self._grasp_pairs_per_obj = [self.grasp_pairs("right", o.contact_geoms) for o in self.objects]
        # the target quadrants' centres (robosuite pick_place.py:456-482)
        self.target_bin_placements = np.array([
            [x + self.bin_size[0] / 4, y + self.bin_size[1] / 4, self.bin2_pos[2]]
            for x, y in (self._bin_low(i) for i in range(len(self.objects)))])
        mask = np.ones(len(self.objects), dtype=bool)
        if self.single_object_mode != 0:
            mask[:] = False
            mask[self.object_id] = True
        self._active = torch.as_tensor(mask, device=self.device)
        self._targets = torch.as_tensor(self.target_bin_placements, dtype=torch.float32, device=self.device)
        bin_x_half = self.bin_size[0] / 2 - 0.05
        bin_y_half = self.bin_size[1] / 2 - 0.05
        self._placements = [
            PlacementSpec(name=o.name, qpos_start=m.jnt_qpos_slice(f"{o.name}_joint0").start,
                          x_range=(-bin_x_half, bin_x_half), y_range=(-bin_y_half, bin_y_half),
                          rotation=self.z_rotation, reference_pos=tuple(self.bin1_pos), z_offset=0.0,
                          bottom_offset=float(o.bottom_offset[2]), horizontal_radius=o.horizontal_radius,
                          ensure_boundary=True)
            for o in self.objects
        ]

    def _sample_placements(self, generator, n):
        return sample_placements(self._placements, n, generator)

    def _obj_pos(self, kin):
        return kin.xpos[:, self._obj_ids]                                       # (B, 4, 3)

    def _objects_in_bins(self, kin):
        """(B, 4): each object inside its quadrant of bin 2 (the negation of
        robosuite's not_in_bin, pick_place.py:404-425)."""
        p = self._obj_pos(kin)
        out = []
        for i in range(len(self.objects)):
            x, y = self._bin_low(i)
            out.append((p[:, i, 0] > x) & (p[:, i, 0] < x + self.bin_size[0] / 2) & (p[:, i, 1] > y)
                       & (p[:, i, 1] < y + self.bin_size[1] / 2) & (p[:, i, 2] > self.bin2_pos[2])
                       & (p[:, i, 2] < self.bin2_pos[2] + 0.1))
        return torch.stack(out, dim=-1)

    def _staged_rewards(self, kin, in_bins):
        """robosuite pick_place.py:308-401: (reach, grasp, lift, hover), each (B,)."""
        reach_mult, grasp_mult, lift_mult, hover_mult = 0.1, 0.35, 0.5, 0.7
        active = self._active & ~in_bins
        any_active = active.any(dim=-1)
        obj_pos = self._obj_pos(kin)
        zero = torch.zeros_like(obj_pos[:, 0, 0])
        dists = torch.linalg.vector_norm(obj_pos - kin.site_xpos[:, self.eef_site, None], dim=-1)
        d_min = torch.where(active, dists, torch.full_like(dists, 1e3)).min(dim=-1).values
        r_reach = torch.where(any_active, (1.0 - torch.tanh(10.0 * d_min)) * reach_mult, zero)

        grasping = torch.stack([self.check_grasp(kin, *pairs) for pairs in self._grasp_pairs_per_obj], dim=-1)
        r_grasp = torch.where((grasping & active).any(dim=-1), grasp_mult, zero)

        z_dists = torch.clamp_min(self.bin2_pos[2] + 0.25 - obj_pos[..., 2], 0.0)
        z_min = torch.where(active, z_dists, torch.full_like(z_dists, 1e3)).min(dim=-1).values
        r_lift = torch.where(r_grasp > 0, grasp_mult + (1.0 - torch.tanh(15.0 * z_min)) * (lift_mult - grasp_mult), zero)

        t = self._targets.to(obj_pos.dtype)
        xy_d = torch.linalg.vector_norm(obj_pos[..., :2] - t[:, :2], dim=-1)
        above = ((torch.abs(obj_pos[..., 0] - t[:, 0]) < self.bin_size[0] / 4.0)
                 & (torch.abs(obj_pos[..., 1] - t[:, 1]) < self.bin_size[1] / 4.0))
        # objects above their bins hover from lift_mult, the others from r_lift
        near = (1.0 - torch.tanh(10.0 * xy_d)) * (hover_mult - lift_mult)
        r_hover_all = torch.where(above, lift_mult + near, r_lift[:, None] + near)
        r_hover = torch.where(active, r_hover_all, torch.zeros_like(r_hover_all)).max(dim=-1).values
        return r_reach, r_grasp, r_lift, r_hover

    def _check_success(self, kin):
        return (self._objects_in_bins(kin) | ~self._active).all(dim=-1)

    def reward(self, physics, kin):
        """robosuite pick_place.py:274-306: one per active object in its bin,
        plus (shaped) the best staged reward; scaled by reward_scale (/ 4
        with all four objects)."""
        in_bins = self._objects_in_bins(kin)
        r = (in_bins & self._active).to(kin.xpos.dtype).sum(dim=-1)
        if self.reward_shaping:
            r = r + torch.stack(self._staged_rewards(kin, in_bins), dim=-1).max(dim=-1).values
        if self.reward_scale is not None:
            r = r * self.reward_scale
            if self.single_object_mode == 0:
                r = r / 4.0
        return r

    def _get_observations(self, physics, kin):
        """The raw PickPlace observation dict (robosuite pick_place.py:
        539-667 + the robot's proprioception), batched."""
        robot = self.robots[0]
        qp = physics.qpos[:, robot.arm_qpos_idx["right"]]
        eef_pos = kin.site_xpos[:, self.eef_site]
        obs = {
            "robot0_joint_pos": qp,
            "robot0_joint_pos_cos": torch.cos(qp),
            "robot0_joint_pos_sin": torch.sin(qp),
            "robot0_joint_vel": physics.qvel[:, robot.arm_qvel_idx["right"]],
            "robot0_eef_pos": eef_pos,
            "robot0_eef_quat": T.mat2quat(kin.site_xmat[:, self.eef_site]),
            "robot0_gripper_qpos": physics.qpos[:, robot.gripper_joint_qpos_idx["right"]],
            "robot0_gripper_qvel": physics.qvel[:, robot.gripper_joint_qvel_idx["right"]],
        }
        for i, o in enumerate(self.objects):
            b = self.obj_body_ids[i]
            obs[f"{o.name}_pos"] = kin.xpos[:, b]
            obs[f"{o.name}_quat"] = T.convert_quat(kin.xquat[:, b], to="xyzw")
            obs[f"{o.name}_to_eef_pos"] = kin.xpos[:, b] - eef_pos
        return obs


@register_env
class PickPlaceSingle(PickPlace):
    def __init__(self, **kwargs):
        if "single_object_mode" in kwargs:
            raise ValueError("PickPlaceSingle sets single_object_mode itself")
        super().__init__(single_object_mode=1, **kwargs)


@register_env
class PickPlaceMilk(PickPlace):
    def __init__(self, **kwargs):
        super().__init__(single_object_mode=2, object_type="milk", **kwargs)


@register_env
class PickPlaceBread(PickPlace):
    def __init__(self, **kwargs):
        super().__init__(single_object_mode=2, object_type="bread", **kwargs)


@register_env
class PickPlaceCereal(PickPlace):
    def __init__(self, **kwargs):
        super().__init__(single_object_mode=2, object_type="cereal", **kwargs)


@register_env
class PickPlaceCan(PickPlace):
    def __init__(self, **kwargs):
        super().__init__(single_object_mode=2, object_type="can", **kwargs)
