"""TwoArmTransport: carry the payload to the target bin and the trash to the
trash bin (the JAX package's envs/two_arm_transport.py; robosuite
environments/manipulation/two_arm_transport.py: the staged reward (:226+),
success = the payload in the target bin and the trash in the trash bin
(:596-603); the Transport group of models/objects/group/transport.py
re-derived from open bins and a lid).

Two tables, the start and trash bins fixed on robot0's, the target bin on
robot1's. The payload (a hammer) starts in the start bin under the lid and
the trash (a cube) on table 0: fixed poses, as the JAX package's
_sample_placements gives them (it draws nothing). The world compacts its
905 candidate rows and holds two robots, so it steps unfused.
"""

from __future__ import annotations

import numpy as np
import torch

from robosuite_tpu_torch.envs.base import RobotEnv, register_env
from robosuite_tpu_torch.envs.two_arm import _normalize_two_arm, _place_two_robots, _two_arm_pairs, _two_eef_sites
from robosuite_tpu_torch.models.arenas import MultiTableArena
from robosuite_tpu_torch.models.objects import BoxObject
from robosuite_tpu_torch.models.objects.composite_objects import BinObject, HammerObject, LidObject
from robosuite_tpu_torch.models.tasks import ManipulationTask
from robosuite_tpu_torch.utils import transforms as T


@register_env
class TwoArmTransport(RobotEnv):
    def __init__(self, robots=("Panda", "Panda"), env_configuration="opposed", tables_full_size=(0.35, 0.7, 0.05),
                 reward_scale=1.0, reward_shaping=False, **kwargs):
        robots, self.env_configuration = _normalize_two_arm(robots, env_configuration)
        self.tables_full_size = np.array(tables_full_size)
        self.table_offsets = np.array([[-0.35, 0, 0.8], [0.35, 0, 0.8]])
        t0, t1 = self.table_offsets
        # the bins' centres: start and trash on table 0, target on table 1
        self.start_bin_pos = t0 + np.array([0.0, -0.15, 0.06])
        self.trash_bin_pos = t0 + np.array([0.0, 0.15, 0.06])
        self.target_bin_pos = t1 + np.array([0.0, 0.15, 0.06])
        super().__init__(robots=robots, reward_scale=reward_scale, reward_shaping=reward_shaping, **kwargs)

    def _load_model(self):
        _place_two_robots(self.robot_models, self.env_configuration, 1.4)
        arena = MultiTableArena(table_offsets=self.table_offsets, table_full_sizes=self.tables_full_size)
        self.payload = HammerObject("payload", handle_length=0.14)
        self.trash = BoxObject("trash", size=[0.02, 0.02, 0.02], rgba=[0.2, 0.6, 0.2, 1])
        self.start_bin = BinObject("start_bin")
        self.target_bin = BinObject("target_bin")
        self.trash_bin = BinObject("trash_bin")
        self.lid = LidObject("lid")
        for bin_obj, pos in ((self.start_bin, self.start_bin_pos), (self.trash_bin, self.trash_bin_pos),
                             (self.target_bin, self.target_bin_pos)):
            bin_obj.get_obj().pos = pos
        self.task = ManipulationTask(arena, self.robot_models, [self.payload, self.trash, self.start_bin,
                                                                self.target_bin, self.trash_bin, self.lid])

    def _setup_references(self):
        m = self.model
        self.payload_body = m.body_name2id(self.payload.root_body)
        self.trash_body = m.body_name2id(self.trash.root_body)
        self.lid_body = m.body_name2id(self.lid.root_body)
        self.eef_sites = _two_eef_sites(self.robots)
        # each gripper's fingerpad pairs on the payload's handle
        self._payload_grasp = [self.grasp_pairs(arm, self.payload.handle_geoms, robot_idx=i)
                               for i, _, arm in _two_arm_pairs(self.robots)]
        # the payload in the start bin under the lid, the trash on table 0
        t0 = self.table_offsets[0]
        up = np.array([1.0, 0.0, 0.0, 0.0])
        self._init_poses = {"payload": np.concatenate([self.start_bin_pos + [0, 0, 0.05], up]),
                            "trash": np.concatenate([t0 + [0.0, 0.0, 0.05 + 0.02], up]),
                            "lid": np.concatenate([self.start_bin_pos + [0, 0, 0.12], up])}

    def _sample_placements(self, generator, n):
        """The fixed initial poses of the payload, the trash and the lid in
        every scenario: nothing is drawn."""
        m, idx, vals = self.model, [], []
        for name, pose in self._init_poses.items():
            sl = m.jnt_qpos_slice(f"{name}_joint0")
            idx.extend(range(sl.start, sl.stop))
            vals.append(pose)
        row = torch.as_tensor(np.concatenate(vals), dtype=torch.float32, device=self.device)
        return idx, row.expand(n, -1)

    @staticmethod
    def _in_bin(pos, bin_pos, half=(0.09, 0.09)):
        d = torch.abs(pos - torch.as_tensor(bin_pos, dtype=pos.dtype, device=pos.device))
        return (d[:, 0] < half[0]) & (d[:, 1] < half[1]) & (d[:, 2] < 0.12)

    def _check_success(self, kin):
        """The payload in the target bin and the trash in the trash bin
        (two_arm_transport.py:596-603)."""
        return (self._in_bin(kin.xpos[:, self.payload_body], self.target_bin_pos)
                & self._in_bin(kin.xpos[:, self.trash_body], self.trash_bin_pos))

    def _dist(self, kin, body, point):
        return torch.linalg.vector_norm(
            kin.xpos[:, body] - torch.as_tensor(point, dtype=kin.xpos.dtype, device=kin.xpos.device), dim=-1)

    def reward(self, physics, kin):
        """1 on success; shaped, the stages summed: the lid off the start bin
        (0.1), the payload grasped by either gripper (0.2), the payload near
        the target bin and the trash near the trash bin (0.35 each, tanh);
        scaled by reward_scale."""
        success = self._check_success(kin)
        r = success.to(kin.xpos.dtype)
        if self.reward_shaping:
            lid_xy = kin.xpos[:, self.lid_body, :2] - torch.as_tensor(
                self.start_bin_pos[:2], dtype=kin.xpos.dtype, device=kin.xpos.device)
            lid_off = torch.linalg.vector_norm(lid_xy, dim=-1) > 0.12
            grasped = self.check_grasp(kin, *self._payload_grasp[0]) | self.check_grasp(kin, *self._payload_grasp[1])
            shaped = (0.1 * lid_off + 0.2 * grasped
                      + 0.35 * (1.0 - torch.tanh(3.0 * self._dist(kin, self.payload_body, self.target_bin_pos)))
                      + 0.35 * (1.0 - torch.tanh(3.0 * self._dist(kin, self.trash_body, self.trash_bin_pos))))
            r = torch.where(success, 1.0, shaped)
        if self.reward_scale is not None:
            r = r * self.reward_scale
        return r

    def _get_observations(self, physics, kin):
        obs = {}
        for k, (_, robot, arm) in enumerate(_two_arm_pairs(self.robots)):
            obs[f"robot{k}_joint_pos"] = physics.qpos[:, robot.arm_qpos_idx[arm]]
            obs[f"robot{k}_eef_pos"] = kin.site_xpos[:, self.eef_sites[k]]
            obs[f"robot{k}_eef_quat"] = T.mat2quat(kin.site_xmat[:, self.eef_sites[k]])
        obs["payload_pos"] = kin.xpos[:, self.payload_body]
        obs["trash_pos"] = kin.xpos[:, self.trash_body]
        obs["lid_pos"] = kin.xpos[:, self.lid_body]
        return obs
