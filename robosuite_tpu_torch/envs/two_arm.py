"""Two-arm environments: TwoArmLift, TwoArmPegInHole and TwoArmHandover
with two robots (the JAX package's envs/two_arm.py; robosuite
environments/manipulation/two_arm_env.py (placements), two_arm_lift.py
(reward :221-300, success :490-501), two_arm_peg_in_hole.py (alignment
reward, the peg and the plate welded at the eefs), two_arm_handover.py
(the staged reach / grasp / hover reward, success :545+)).

With two robots, env_configuration "opposed" (the default: the robots
face each other across the table, turned by +-pi/2) or "parallel" (side by
side, +-0.25 m); with one, the "single-robot" configuration: one bimanual
robot (Baxter) at its table offset, its right and left arms the two
endpoints. Every such world steps unfused (two robots, or two arms), as
the JAX package's do: TwoArmLift compacts its candidate rows (620 with two
Pandas) and TwoArmHandover its 203, and TwoArmPegInHole solves its 117
static rows.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from robosuite_tpu_torch.envs.base import RobotEnv, register_env
from robosuite_tpu_torch.models import spec as S
from robosuite_tpu_torch.models.arenas import EmptyArena, TableArena
from robosuite_tpu_torch.models.grippers import gripper_factory
from robosuite_tpu_torch.models.objects.composite_objects import HammerObject, PotWithHandlesObject
from robosuite_tpu_torch.models.objects.xml_objects import PlateWithHoleObject
from robosuite_tpu_torch.models.tasks import ManipulationTask
from robosuite_tpu_torch.utils import transforms as T
from robosuite_tpu_torch.utils.placement import PlacementSpec, sample_placements


def _normalize_two_arm(robots, env_configuration):
    """robosuite two_arm_env.py:29-55: one robot selects the "single-robot"
    configuration, which takes a bimanual robot (checked once the robot is
    built, _place_two_robots); two robots take "opposed" (the default) or
    "parallel"."""
    robots = [robots] if isinstance(robots, str) else list(robots)
    if len(robots) == 1:
        return robots, "single-robot"
    if env_configuration in ("default", None):
        env_configuration = "opposed"
    if env_configuration not in ("opposed", "parallel"):
        raise ValueError(f"env_configuration {env_configuration!r}: 'opposed' or 'parallel'")
    return robots, env_configuration


def _place_two_robots(robot_models, env_configuration, table_length):
    """robosuite two_arm_lift.py:302-326: single-robot, the one base at its
    table offset (a one-arm robot raises ValueError, robosuite
    two_arm_env.py's configuration check); opposed, each base at its table
    offset turned by +pi/2 and -pi/2 about z; parallel, side by side."""
    if env_configuration == "single-robot":
        rm = robot_models[0]
        if rm.arm_type != "bimanual":
            raise ValueError(f"the 'single-robot' two-arm configuration needs a bimanual robot (Baxter); "
                             f"{type(rm).__name__} has one arm: pass two robots")
        rm.set_base_xpos(np.array(rm.base_xpos_offset["table"](table_length)))
    elif env_configuration == "opposed":
        for rm, rotation in zip(robot_models, (np.pi / 2, -np.pi / 2)):
            xpos = np.array(rm.base_xpos_offset["table"](table_length))
            c, s = math.cos(rotation), math.sin(rotation)
            rm.set_base_xpos(np.array([c * xpos[0] - s * xpos[1], s * xpos[0] + c * xpos[1], xpos[2]]))
            rm.set_base_ori((0, 0, rotation))
    else:
        for rm, offset in zip(robot_models, (-0.25, 0.25)):
            rm.set_base_xpos(np.array(rm.base_xpos_offset["table"](table_length)) + np.array((0, offset, 0)))


def _two_arm_pairs(items):
    """[(robot index, item, arm)] of the two manipulation endpoints: the
    right and the left arm of the one bimanual robot, or the right arm of
    each of the two robots (robosuite two_arm_env.py's gripper0 /
    gripper1)."""
    items = list(items)
    if len(items) == 1:
        return [(0, items[0], "right"), (0, items[0], "left")]
    return [(i, r, "right") for i, r in enumerate(items)]


def _two_eef_sites(robots):
    """The eef sites of the two endpoints (two_arm_env.py:98-140)."""
    return [r.eef_site_id[arm] for _, r, arm in _two_arm_pairs(robots)]


@register_env
class TwoArmLift(RobotEnv):
    def __init__(self, robots=("Panda", "Panda"), env_configuration="opposed", table_full_size=(0.8, 0.8, 0.05),
                 table_friction=(1.0, 0.005, 0.0001), reward_scale=1.0, reward_shaping=False, **kwargs):
        robots, self.env_configuration = _normalize_two_arm(robots, env_configuration)
        self.table_full_size = np.array(table_full_size)
        self.table_friction = table_friction
        self.table_offset = np.array((0, 0, 0.8))
        super().__init__(robots=robots, reward_scale=reward_scale, reward_shaping=reward_shaping, **kwargs)

    def _load_model(self):
        _place_two_robots(self.robot_models, self.env_configuration, self.table_full_size[0])
        arena = TableArena(table_full_size=self.table_full_size, table_friction=self.table_friction,
                           table_offset=self.table_offset)
        self.pot = PotWithHandlesObject(name="pot")
        self.task = ManipulationTask(arena, self.robot_models, self.pot)

    def _setup_references(self):
        m = self.model
        self.pot_body_id = m.body_name2id(self.pot.root_body)
        self.pot_center_id = m.site_name2id(self.pot.important_sites["center"])
        self.handle_site_ids = [m.site_name2id(self.pot.important_sites[f"handle{k}"]) for k in (0, 1)]
        self.eef_sites = _two_eef_sites(self.robots)
        # each gripper's fingerpad pairs on its own handle
        self._grasp_pairs = [self.grasp_pairs(arm, self.pot.handle_geoms[k], robot_idx=i)
                             for k, (i, _, arm) in enumerate(_two_arm_pairs(self.robots))]
        self._placements = [PlacementSpec(
            name="pot", qpos_start=m.jnt_qpos_slice("pot_joint0").start, x_range=(-0.03, 0.03),
            y_range=(-0.03, 0.03), rotation=(np.pi - np.pi / 3, np.pi + np.pi / 3),
            reference_pos=tuple(self.table_offset), z_offset=0.001, bottom_offset=float(self.pot.bottom_offset[2]),
            horizontal_radius=self.pot.horizontal_radius)]

    def _sample_placements(self, generator, n):
        return sample_placements(self._placements, n, generator)

    def _pot_bottom(self, kin):
        return kin.site_xpos[:, self.pot_center_id, 2] - float(self.pot.top_offset[2])

    def _check_success(self, kin):
        """The pot's bottom 10 cm above the table (two_arm_lift.py:490-501)."""
        return self._pot_bottom(kin) > self.table_offset[2] + 0.10

    def reward(self, physics, kin):
        """robosuite two_arm_lift.py:221-300: 3 on success while the pot is
        within 30 degrees of level; shaped, the lift term plus each
        gripper's reach to its handle (0.75 where it grasps it); scaled by
        reward_scale / 3."""
        cos_z = kin.xmat[:, self.pot_body_id, 2, 2]
        direction_coef = (cos_z >= math.cos(math.pi / 6)).to(cos_z.dtype)
        success = self._check_success(kin)
        r = torch.where(success, 3.0 * direction_coef, torch.zeros_like(cos_z))
        if self.reward_shaping:
            elevation = self._pot_bottom(kin) - float(self.table_offset[2])
            shaped = torch.clamp(torch.clamp_min(elevation - 0.05, 0.0) * 15.0, max=1.5) * direction_coef
            for i in range(2):
                d = torch.linalg.vector_norm(kin.site_xpos[:, self.eef_sites[i]]
                                             - kin.site_xpos[:, self.handle_site_ids[i]], dim=-1)
                reaching = 0.5 * (1.0 - torch.tanh(10.0 * d))
                grasping = self.check_grasp(kin, *self._grasp_pairs[i])
                shaped = shaped + torch.where(grasping, torch.full_like(d, 0.5 + 0.25), reaching)
            r = torch.where(success, r, shaped)
        if self.reward_scale is not None:
            r = r * self.reward_scale / 3.0
        return r

    def _get_observations(self, physics, kin):
        obs = {}
        for k, (i, robot, arm) in enumerate(_two_arm_pairs(self.robots)):
            qp = physics.qpos[:, robot.arm_qpos_idx[arm]]
            site = self.eef_sites[k]
            obs[f"robot{k}_joint_pos"] = qp
            obs[f"robot{k}_joint_pos_cos"] = torch.cos(qp)
            obs[f"robot{k}_joint_pos_sin"] = torch.sin(qp)
            obs[f"robot{k}_joint_vel"] = physics.qvel[:, robot.arm_qvel_idx[arm]]
            obs[f"robot{k}_eef_pos"] = kin.site_xpos[:, site]
            obs[f"robot{k}_eef_quat"] = T.mat2quat(kin.site_xmat[:, site])
            obs[f"robot{k}_gripper_qpos"] = physics.qpos[:, robot.gripper_joint_qpos_idx[arm]]
        h0, h1 = (kin.site_xpos[:, h] for h in self.handle_site_ids)
        obs["pot_pos"] = kin.xpos[:, self.pot_body_id]
        obs["pot_quat"] = T.convert_quat(kin.xquat[:, self.pot_body_id], to="xyzw")
        obs["handle0_xpos"] = h0
        obs["handle1_xpos"] = h1
        obs["gripper0_to_handle0"] = h0 - kin.site_xpos[:, self.eef_sites[0]]
        obs["gripper1_to_handle1"] = h1 - kin.site_xpos[:, self.eef_sites[1]]
        return obs


@register_env
class TwoArmPegInHole(RobotEnv):
    """A peg welded under robot0's eef body and a plate with a hole under
    robot1's, both grippers swapped for NullGripper (robosuite
    two_arm_peg_in_hole.py; no table)."""

    def __init__(self, robots=("Panda", "Panda"), env_configuration="opposed", peg_radius=(0.015, 0.03),
                 peg_length=0.13, reward_scale=1.0, reward_shaping=False, **kwargs):
        robots, self.env_configuration = _normalize_two_arm(robots, env_configuration)
        self.peg_radius = peg_radius
        self.peg_length = peg_length
        super().__init__(robots=robots, reward_scale=reward_scale, reward_shaping=reward_shaping, **kwargs)

    def _load_model(self):
        _place_two_robots(self.robot_models, self.env_configuration, 0.8)
        # no grippers: each default gripper (its bodies under the eef, its
        # actuators) gives way to a NullGripper (two_arm_peg_in_hole.py:262-270)
        pairs = _two_arm_pairs(self.robot_models)
        for i, rm, arm in pairs:
            eef_body = rm.root_subtree().find_body(rm.eef_name[arm])
            pref = f"gripper{i}_{arm}_"
            eef_body.children = [c for c in eef_body.children if not c.name.startswith(pref)]
            rm._actuators = [a for a in rm._actuators if not a.name.startswith(pref)]
            rm.grippers.pop(arm)
            rm.add_gripper(gripper_factory("NullGripper", idn=i, arm=arm), arm)
        # the peg under robot0's eef body, the plate under robot1's (:278-299)
        peg = S.BodySpec("peg", pos=(0, 0, self.peg_length))
        peg.add_geom(S.GeomSpec("peg_g0", type="cylinder", size=(self.peg_radius[0], self.peg_length), density=500))
        peg.add_site(S.SiteSpec("peg_center", pos=(0, 0, 0), size=(0.005,)))
        (_, rm0, arm0), (_, rm1, arm1) = pairs
        rm0.root_subtree().find_body(rm0.eef_name[arm0]).children.append(peg)
        self.plate = PlateWithHoleObject(name="plate")
        plate_root = self.plate.get_obj()
        plate_root.pos = np.array([0, 0, 0.05])
        plate_root.quat = np.array([0.7071068, 0, 0.7071068, 0])
        rm1.root_subtree().find_body(rm1.eef_name[arm1]).children.append(plate_root)
        self.task = ManipulationTask(EmptyArena(), self.robot_models, None)

    def _setup_references(self):
        m = self.model
        self.peg_body_id = m.body_name2id("peg")
        self.plate_body_id = m.body_name2id(self.plate.root_body)
        self.eef_sites = _two_eef_sites(self.robots)

    def _peg_alignment(self, kin):
        """(t, d, cos) (B,) each: the peg's offset along its axis to the
        hole's centre, its distance off the axis line, and the cosine of
        its axis with the hole's normal (two_arm_peg_in_hole.py:440-487)."""
        return peg_alignment(kin.xpos[:, self.plate_body_id], kin.xmat[:, self.plate_body_id],
                             kin.xpos[:, self.peg_body_id], kin.xmat[:, self.peg_body_id])

    def _check_success(self, kin):
        t, d, cos = self._peg_alignment(kin)
        return (d < 0.06) & (-0.12 <= t) & (t <= 0.14) & (cos > 0.95)

    def reward(self, physics, kin):
        """1 on success; shaped, 5 on success, else the reach of the peg to
        the hole plus the alignment terms; scaled by reward_scale / 5
        (shaped) or reward_scale."""
        t, d, cos = self._peg_alignment(kin)
        success = self._check_success(kin)
        r = success.to(t.dtype)
        if self.reward_shaping:
            dist = torch.linalg.vector_norm(kin.xpos[:, self.plate_body_id] - kin.xpos[:, self.peg_body_id], dim=-1)
            shaped = (1.0 - torch.tanh(dist)) + 1.0 - torch.tanh(torch.abs(t)) + 1.0 - torch.tanh(d) + cos
            r = torch.where(success, torch.full_like(t, 5.0), shaped)
        if self.reward_scale is not None:
            r = r * self.reward_scale / (5.0 if self.reward_shaping else 1.0)
        return r

    def _get_observations(self, physics, kin):
        t, d, cos = self._peg_alignment(kin)
        obs = {}
        for i, robot in enumerate(self.robots):
            obs[f"robot{i}_joint_pos"] = physics.qpos[:, robot.arm_qpos_idx["right"]]
            obs[f"robot{i}_joint_vel"] = physics.qvel[:, robot.arm_qvel_idx["right"]]
            obs[f"robot{i}_eef_pos"] = kin.site_xpos[:, self.eef_sites[i]]
        obs["peg_pos"] = kin.xpos[:, self.peg_body_id]
        obs["peg_quat"] = T.convert_quat(kin.xquat[:, self.peg_body_id], to="xyzw")
        obs["hole_pos"] = kin.xpos[:, self.plate_body_id]
        obs["t"] = t[:, None]
        obs["d"] = d[:, None]
        obs["angle"] = cos[:, None]
        return obs


@register_env
class TwoArmHandover(RobotEnv):
    """Hand a hammer from robot0's gripper to robot1's (robosuite
    two_arm_handover.py, as the JAX package re-derives it): the hammer
    placed flat on the table, turned about z at random."""

    def __init__(self, robots=("Panda", "Panda"), env_configuration="opposed", table_full_size=(0.8, 1.2, 0.05),
                 reward_scale=1.0, reward_shaping=False, **kwargs):
        robots, self.env_configuration = _normalize_two_arm(robots, env_configuration)
        self.table_full_size = np.array(table_full_size)
        self.table_offset = np.array((0, 0, 0.8))
        self.height_threshold = 0.1
        super().__init__(robots=robots, reward_scale=reward_scale, reward_shaping=reward_shaping, **kwargs)

    def _load_model(self):
        _place_two_robots(self.robot_models, self.env_configuration, self.table_full_size[0])
        arena = TableArena(table_full_size=self.table_full_size, table_offset=self.table_offset)
        self.hammer = HammerObject(name="hammer")
        self.task = ManipulationTask(arena, self.robot_models, self.hammer)

    def _setup_references(self):
        m = self.model
        self.hammer_body_id = m.body_name2id(self.hammer.root_body)
        self.eef_sites = _two_eef_sites(self.robots)
        # each gripper's fingerpad pairs on the hammer's handle
        self._grasp0, self._grasp1 = (self.grasp_pairs(arm, self.hammer.handle_geoms, robot_idx=i)
                                      for i, _, arm in _two_arm_pairs(self.robots))
        self._placements = [PlacementSpec(
            name="hammer", qpos_start=m.jnt_qpos_slice("hammer_joint0").start, x_range=(-0.1, 0.1),
            y_range=(-0.05, 0.05), rotation=None, reference_pos=tuple(self.table_offset), z_offset=0.01,
            bottom_offset=float(self.hammer.bottom_offset[2]), horizontal_radius=self.hammer.horizontal_radius)]

    def _sample_placements(self, generator, n):
        return sample_placements(self._placements, n, generator)

    def _hammer_height(self, kin):
        return kin.xpos[:, self.hammer_body_id, 2] - float(self.table_offset[2])

    def _check_success(self, kin):
        """robot1 holds the hammer above the height threshold and robot0 has
        let go (two_arm_handover.py:545+)."""
        grasp0 = self.check_grasp(kin, *self._grasp0)
        grasp1 = self.check_grasp(kin, *self._grasp1)
        return grasp1 & ~grasp0 & (self._hammer_height(kin) > self.height_threshold)

    def reward(self, physics, kin):
        """2 on success; shaped, the largest of robot0's reach to the hammer
        (0.1 at most), the lift (0.5 while robot0 holds it above the
        threshold) and robot1's hover over it (0.5 to 1.0 while lifted);
        scaled by reward_scale / 2."""
        success = self._check_success(kin)
        r = torch.where(success, 2.0, 0.0)
        if self.reward_shaping:
            grasp0 = self.check_grasp(kin, *self._grasp0)
            hammer = kin.xpos[:, self.hammer_body_id]
            d0, d1 = (torch.linalg.vector_norm(kin.site_xpos[:, s] - hammer, dim=-1) for s in self.eef_sites)
            held = grasp0 & (self._hammer_height(kin) > self.height_threshold)
            r_reach = 0.1 * (1.0 - torch.tanh(10.0 * d0))
            r_lift = torch.where(held, 0.5, 0.0)
            r_hover = torch.where(held, 0.5 + 0.5 * (1.0 - torch.tanh(10.0 * d1)), 0.0)
            r = torch.where(success, 2.0, torch.maximum(torch.maximum(r_reach, r_lift), r_hover))
        if self.reward_scale is not None:
            r = r * self.reward_scale / 2.0
        return r

    def _get_observations(self, physics, kin):
        obs = {}
        for k, (_, robot, arm) in enumerate(_two_arm_pairs(self.robots)):
            obs[f"robot{k}_joint_pos"] = physics.qpos[:, robot.arm_qpos_idx[arm]]
            obs[f"robot{k}_eef_pos"] = kin.site_xpos[:, self.eef_sites[k]]
        obs["hammer_pos"] = kin.xpos[:, self.hammer_body_id]
        obs["hammer_quat"] = T.convert_quat(kin.xquat[:, self.hammer_body_id], to="xyzw")
        return obs


def peg_alignment(hole_pos, hole_mat, peg_pos, peg_mat):
    """The alignment terms of TwoArmPegInHole from the plate's and the
    peg's poses (B, 3), (B, 3, 3): (t, d, cos), each (B,)."""
    v = peg_mat[..., 2]  # the peg's axis in the world
    center = hole_pos + hole_mat[..., 0] * 0.1
    vv = (v * v).sum(-1)
    t = ((center - peg_pos) * v).sum(-1) / (vv + 1e-9)
    d = torch.linalg.vector_norm(torch.linalg.cross(v, peg_pos - center), dim=-1) / (torch.sqrt(vv) + 1e-9)
    normal = hole_mat[..., 2]
    cos = (normal * v).sum(-1) / (torch.linalg.vector_norm(normal, dim=-1) * torch.sqrt(vv) + 1e-9)
    return t, d, cos
