"""NutAssembly: fit the nuts onto their pegs (the JAX package's
envs/nut_assembly.py; robosuite environments/manipulation/
nut_assembly.py: staged rewards (:249-374), on_peg (:375-389), placement
(:407-436), success (:622-640), the variants Single, Square and Round
(:683+)).

The square nut goes on peg1 (a box), the round nut on peg2 (a cylinder).
The world has 186 candidate pairs and compacts its active contact rows
(physics/contact.py uses_row_compaction), so every substep takes the
unfused path: forward products (K1), the contact rows and the contact
solve (K2), as the JAX package's does.
"""

from __future__ import annotations

import numpy as np
import torch

from robosuite_tpu_torch.envs.base import RobotEnv, register_env
from robosuite_tpu_torch.models.arenas import PegsArena
from robosuite_tpu_torch.models.objects.xml_objects import RoundNutObject, SquareNutObject
from robosuite_tpu_torch.models.tasks import ManipulationTask
from robosuite_tpu_torch.utils import transforms as T
from robosuite_tpu_torch.utils.placement import PlacementSpec, sample_placements


@register_env
class NutAssembly(RobotEnv):
    def __init__(self, robots="Panda", single_object_mode=0, nut_type=None, reward_scale=1.0, reward_shaping=False,
                 **kwargs):
        self.single_object_mode = single_object_mode
        self.nut_to_id = {"SquareNut": 0, "RoundNut": 1}
        if nut_type is not None:
            if nut_type not in self.nut_to_id:
                raise ValueError(f"unknown nut_type {nut_type!r}; known: {sorted(self.nut_to_id)}")
            self.nut_id = self.nut_to_id[nut_type]
        else:
            self.nut_id = 0
        self.table_full_size = (0.45, 0.69, 0.05)
        self.table_offset = np.array((0, 0, 0.82))
        super().__init__(robots=robots, reward_scale=reward_scale, reward_shaping=reward_shaping, **kwargs)

    def _load_model(self):
        rm = self.robot_models[0]
        rm.set_base_xpos(rm.base_xpos_offset["table"](self.table_full_size[0]))
        arena = PegsArena(table_full_size=self.table_full_size, table_offset=self.table_offset)
        self.nuts = [SquareNutObject("SquareNut"), RoundNutObject("RoundNut")]
        self.task = ManipulationTask(arena, self.robot_models, self.nuts)

    def _setup_references(self):
        m, dev = self.model, self.device
        self.peg1_body_id = m.body_name2id("peg1")
        self.peg2_body_id = m.body_name2id("peg2")
        self.nut_body_ids = [m.body_name2id(n.root_body) for n in self.nuts]
        self.nut_handle_sites = [m.site_name2id(n.important_sites["handle"]) for n in self.nuts]
        self.eef_site = self.robots[0].eef_site_id["right"]
        self._grasp_pairs_per_nut = [self.grasp_pairs("right", n.contact_geoms) for n in self.nuts]
        self._nut_ids = torch.tensor(self.nut_body_ids, device=dev)
        self._peg_ids = torch.tensor([self.peg1_body_id, self.peg2_body_id], device=dev)  # nut i's peg
        self._handle_ids = torch.tensor(self.nut_handle_sites, device=dev)
        mask = np.ones(len(self.nuts), dtype=bool)
        if self.single_object_mode != 0:
            mask[:] = False
            mask[self.nut_id] = True
        self._active = torch.as_tensor(mask, device=dev)
        # the square nut on the +y side of the table, the round nut on -y,
        # each turned uniformly about z: the JAX package builds a range for
        # the square nut (robosuite's) but passes rotation=None for both
        self._placements = [
            PlacementSpec(name=nut.name, qpos_start=m.jnt_qpos_slice(f"{nut.name}_joint0").start,
                          x_range=(-0.115, -0.11), y_range=yr, rotation=None, reference_pos=tuple(self.table_offset),
                          z_offset=0.02, bottom_offset=float(nut.bottom_offset[2]),
                          horizontal_radius=nut.horizontal_radius)
            for nut, yr in zip(self.nuts, ((0.09, 0.12), (-0.12, -0.09)))
        ]

    def _sample_placements(self, generator, n):
        return sample_placements(self._placements, n, generator)

    def _on_pegs(self, kin):
        """(B, 2): each nut within 3 cm of its peg's axis in x and y and
        below 5 cm over the table (robosuite nut_assembly.py:375-389)."""
        nut, peg = kin.xpos[:, self._nut_ids], kin.xpos[:, self._peg_ids]
        return ((torch.abs(nut[..., 0] - peg[..., 0]) < 0.03) & (torch.abs(nut[..., 1] - peg[..., 1]) < 0.03)
                & (nut[..., 2] < self.table_offset[2] + 0.05))

    def _objects_on_pegs(self, kin):
        """(B, 2): each nut on its peg with the gripper away from it."""
        d = torch.linalg.vector_norm(kin.site_xpos[:, self.eef_site, None] - kin.xpos[:, self._nut_ids], dim=-1)
        return self._on_pegs(kin) & (1.0 - torch.tanh(10.0 * d) < 0.6)

    def _staged_rewards(self, kin, on_pegs):
        """robosuite nut_assembly.py:290-374 over the nuts still to place:
        (reach, grasp, lift, hover), each (B,)."""
        reach_mult, grasp_mult, lift_mult, hover_mult = 0.1, 0.35, 0.5, 0.7
        active = self._active & ~on_pegs
        any_active = active.any(dim=-1)
        zero = torch.zeros_like(kin.xpos[:, 0, 0])
        big = torch.full_like(active, 1e3, dtype=zero.dtype)
        handle_d = torch.linalg.vector_norm(kin.site_xpos[:, self.eef_site, None] - kin.site_xpos[:, self._handle_ids],
                                            dim=-1)
        d_min = torch.where(active, handle_d, big).min(dim=-1).values
        r_reach = torch.where(any_active, (1.0 - torch.tanh(10.0 * d_min)) * reach_mult, zero)

        grasping = torch.stack([self.check_grasp(kin, *pairs) for pairs in self._grasp_pairs_per_nut], dim=-1)
        r_grasp = torch.where((grasping & active).any(dim=-1), grasp_mult, zero)

        nut = kin.xpos[:, self._nut_ids]
        z_dists = torch.clamp_min(self.table_offset[2] + 0.2 - nut[..., 2], 0.0)
        z_min = torch.where(active, z_dists, big).min(dim=-1).values
        r_lift = torch.where(any_active & (r_grasp > 0),
                             grasp_mult + (1.0 - torch.tanh(15.0 * z_min)) * (lift_mult - grasp_mult), zero)

        dists = torch.linalg.vector_norm(kin.xpos[:, self._peg_ids, :2] - nut[..., :2], dim=-1)
        r_hovers = r_lift[:, None] + (1.0 - torch.tanh(10.0 * dists)) * (hover_mult - lift_mult)
        r_hover = torch.where(active, r_hovers, torch.zeros_like(r_hovers)).max(dim=-1).values
        return r_reach, r_grasp, r_lift, r_hover

    def _check_success(self, kin):
        return (self._objects_on_pegs(kin) | ~self._active).all(dim=-1)

    def reward(self, physics, kin):
        """robosuite nut_assembly.py:249-288: one per active nut on its peg,
        plus (shaped) the best staged reward; scaled by reward_scale (/ 2
        with both nuts)."""
        on_pegs = self._objects_on_pegs(kin)
        r = (on_pegs & self._active).to(kin.xpos.dtype).sum(dim=-1)
        if self.reward_shaping:
            r = r + torch.stack(self._staged_rewards(kin, on_pegs), dim=-1).max(dim=-1).values
        if self.reward_scale is not None:
            r = r * self.reward_scale
            if self.single_object_mode == 0:
                r = r / 2.0
        return r

    def _get_observations(self, physics, kin):
        """The raw NutAssembly observation dict (robosuite nut_assembly.py's
        observables + the robot's proprioception), batched."""
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
        for nut, b in zip(self.nuts, self.nut_body_ids):
            obs[f"{nut.name}_pos"] = kin.xpos[:, b]
            obs[f"{nut.name}_quat"] = T.convert_quat(kin.xquat[:, b], to="xyzw")
            obs[f"{nut.name}_to_eef_pos"] = kin.xpos[:, b] - eef_pos
        return obs


@register_env
class NutAssemblySingle(NutAssembly):
    """One nut at a time (robosuite nut_assembly.py:683+)."""

    def __init__(self, **kwargs):
        if "single_object_mode" in kwargs:
            raise ValueError("NutAssemblySingle sets single_object_mode itself")
        super().__init__(single_object_mode=1, **kwargs)


@register_env
class NutAssemblySquare(NutAssembly):
    def __init__(self, **kwargs):
        if "single_object_mode" in kwargs or "nut_type" in kwargs:
            raise ValueError("NutAssemblySquare sets single_object_mode and nut_type itself")
        super().__init__(single_object_mode=2, nut_type="SquareNut", **kwargs)


@register_env
class NutAssemblyRound(NutAssembly):
    def __init__(self, **kwargs):
        if "single_object_mode" in kwargs or "nut_type" in kwargs:
            raise ValueError("NutAssemblyRound sets single_object_mode and nut_type itself")
        super().__init__(single_object_mode=2, nut_type="RoundNut", **kwargs)
