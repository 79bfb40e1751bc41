"""Wipe: wipe the dirt markers off the table with a wiping tool (the JAX
package's envs/wipe.py; robosuite environments/manipulation/wipe.py: the
task config (:14-35), the reward (:386-505), termination (:707-737)).

The robot's default gripper is swapped for the WipingGripper (no
fingers, no actuators). Which markers are wiped, the count of unsafe
steps (an arm link touching anything, or a joint near its limit) and the
count of excess-force steps are per-scenario task state, carried in
EnvState.task_state (WipeTaskState) from the reset through every
step_batch step; `_step_hook` updates it from the step's end-of-step
forward products, replaces the reward and ends an episode early on an
unsafe step or once every marker is wiped.

The JAX package's simplifications are kept: a marker is wiped when the
grip site passes within the tool's half-width of it (in the table plane,
within 3 cm in height) while a tool geom touches the table, and an arm
collision is any contact of a robot0_ geom (the model has no candidate
pair with one, so only a joint near its limit makes a step unsafe).
Wipe's world compacts its rows, so the eef force is zero (as in the JAX
package) and the pressing and excess-force terms never fire. `reward` (the planners' return) is
zero, the JAX base env's: Wipe's MPPI weights its samples uniformly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from robosuite_tpu_torch.envs.base import RobotEnv, register_env
from robosuite_tpu_torch.models.arenas import WipeArena
from robosuite_tpu_torch.models.grippers import gripper_factory
from robosuite_tpu_torch.models.tasks import ManipulationTask
from robosuite_tpu_torch.utils import transforms as T


@dataclasses.dataclass
class WipeTaskState:
    """Per-scenario Wipe bookkeeping (robosuite wipe.py's wiped_markers,
    collisions and f_excess counters, :268-269, 435, 485)."""

    wiped: torch.Tensor       # (B, num_markers) bool
    collisions: torch.Tensor  # (B,) int32: unsafe steps
    f_excess: torch.Tensor    # (B,) int32: steps above the force limit


DEFAULT_WIPE_CONFIG = {
    "arm_limit_collision_penalty": -10.0,
    "wipe_contact_reward": 0.01,
    "unit_wiped_reward": 50.0,
    "ee_accel_penalty": 0.0,
    "excess_force_penalty_mul": 0.05,
    "distance_multiplier": 5.0,
    "distance_th_multiplier": 5.0,
    "task_complete_reward": 100.0,
    "contact_threshold": 1.0,
    "pressure_threshold": 0.5,
    "pressure_threshold_max": 60.0,
}


@register_env
class Wipe(RobotEnv):
    def __init__(self, robots="Panda", task_config=None, num_markers=10, reward_scale=1.0, reward_shaping=True,
                 seed=None, early_terminations=True, **kwargs):
        self.early_terminations = early_terminations
        self.task_config = dict(DEFAULT_WIPE_CONFIG)
        if task_config:
            self.task_config.update(task_config)
        self.num_markers = num_markers
        self.table_full_size = (0.8, 0.8, 0.05)
        self.table_offset = np.array((0, 0, 0.8))
        self._model_rng_seed = seed
        super().__init__(robots=robots, reward_scale=reward_scale, reward_shaping=reward_shaping, **kwargs)

    def _load_model(self):
        # the WipingGripper in place of the robot's default gripper (the JAX
        # wipe.py:79-101): the default's bodies and actuators removed from
        # the built robot model, the wiping tool attached at the eef
        rm = self.robot_models[0]
        rm.grippers.clear()
        eef_body = rm.root_subtree().find_body(rm.eef_name["right"])
        eef_body.children = [c for c in eef_body.children if not c.name.startswith("gripper0_")]
        rm._actuators = [a for a in rm._actuators if not a.name.startswith("gripper0_")]
        rm.add_gripper(gripper_factory("WipingGripper", idn=0, arm="right"), "right")
        rm.set_base_xpos(rm.base_xpos_offset["table"](self.table_full_size[0]))
        self.arena = WipeArena(table_full_size=self.table_full_size, table_friction=(0.01, 0.005, 0.0001),
                               table_offset=self.table_offset, num_markers=self.num_markers,
                               seed=self._model_rng_seed)
        self.task = ManipulationTask(self.arena, self.robot_models, None)

    def _setup_references(self):
        m = self.model
        self.eef_site = self.robots[0].eef_site_id["right"]
        self.marker_body_ids = [m.body_name2id(n) for n in self.arena.marker_names]
        self._marker_ids = torch.tensor(self.marker_body_ids, device=self.device)
        # the wiping tool's pairs with the table top
        tool = [n for n in m.geom_names if n.startswith("gripper0_right_")]
        self._tool_table_pairs = self._contact_pairs(tool, ["table_collision"])
        self.wipe_radius = self.arena.line_width / 2 + 0.05  # the tool's half-width
        # an arm link (robot0_, not the tool) touching anything (robosuite
        # check_contact(robot_model), wipe.py:431-435)
        arm = [n for n in m.geom_names if n.startswith("robot0_")]
        self._arm_collision_pairs = self._contact_pairs(arm, [n for n in m.geom_names if not n.startswith("robot0_")])

    def _reset_task_state(self, n):
        dev = self.device
        return WipeTaskState(wiped=torch.zeros(n, self.num_markers, dtype=torch.bool, device=dev),
                             collisions=torch.zeros(n, dtype=torch.int32, device=dev),
                             f_excess=torch.zeros(n, dtype=torch.int32, device=dev))

    def _marker_positions(self, kin):
        return kin.xpos[:, self._marker_ids]                                # (B, M, 3)

    def _wipe_update(self, kin, wiped):
        """-> (wiped', newly (B, M)): the markers under the tool while it
        touches the table."""
        eef = kin.site_xpos[:, self.eef_site]
        markers = self._marker_positions(kin)
        d_xy = torch.linalg.vector_norm(markers[..., :2] - eef[:, None, :2], dim=-1)
        close_z = torch.abs(markers[..., 2] - eef[:, None, 2]) < 0.03
        touching = self._any_contact(kin, self._tool_table_pairs)
        newly = (d_xy < self.wipe_radius) & close_z & touching[:, None] & ~wiped
        return wiped | newly, newly

    def _step_hook(self, prev, new, obs, reward, done, kin):
        """The JAX Wipe._step_impl after the base step: the unsafe check,
        the wiping progress (kept only in safe steps), the reward, the task
        state, the wiped_markers observation, the info keys and, with
        early_terminations, done on an unsafe step or once all are wiped."""
        ts = prev.task_state if prev.task_state is not None else self._reset_task_state(kin.xpos.shape[0])
        colliding = self._any_contact(kin, self._arm_collision_pairs)
        unsafe = colliding | self.robots[0].check_q_limits(new.physics.qpos)
        total_force = torch.linalg.vector_norm(obs["robot0_eef_force"], dim=-1)
        wiped, newly = self._wipe_update(kin, ts.wiped)
        wiped = torch.where(unsafe[:, None], ts.wiped, wiped)
        newly = newly & ~unsafe[:, None]
        reward, f_over = self._wipe_reward(kin, wiped, newly, unsafe, total_force)
        ts = WipeTaskState(wiped=wiped, collisions=ts.collisions + unsafe.to(torch.int32),
                           f_excess=ts.f_excess + f_over.to(torch.int32))
        obs["wiped_markers"] = wiped
        success = wiped.all(dim=-1)
        info = dict(nwipedmarkers=wiped.sum(dim=-1), colls=ts.collisions,
                    percent_viapoints_=wiped.to(torch.float32).mean(dim=-1), f_excess=ts.f_excess,
                    total_force_ee=total_force)
        if self.early_terminations:
            done = done | unsafe | success
        return dataclasses.replace(new, task_state=ts), obs, reward, done, info

    def _wipe_reward(self, kin, wiped, newly, unsafe, total_force):
        """robosuite wipe.py:386-505 (the JAX _wipe_reward): the wiped
        markers, the reach to the remaining markers' centroid, the contact,
        pressing and excess-force terms, the completion bonus, all replaced
        by the penalty on an unsafe step; scaled to the horizon.
        -> (reward (B,), f_over (B,) bool)."""
        cfg = self.task_config
        r = newly.sum(dim=-1).to(kin.xpos.dtype) * cfg["unit_wiped_reward"]
        all_wiped = wiped.all(dim=-1)
        f_over = total_force > cfg["pressure_threshold_max"]
        zero = torch.zeros_like(r)
        if self.reward_shaping:
            markers = self._marker_positions(kin)
            eef = kin.site_xpos[:, self.eef_site]
            active = ~wiped
            n_active = torch.clamp_min(active.sum(dim=-1), 1).to(r.dtype)
            centroid = torch.where(active[..., None], markers, torch.zeros_like(markers)).sum(dim=1) / n_active[:, None]
            dist = torch.linalg.vector_norm(centroid - eef, dim=-1)
            reach = cfg["distance_multiplier"] * (1.0 - torch.tanh(cfg["distance_th_multiplier"] * dist))
            reach = torch.where(all_wiped, zero, reach)
            touching = self._any_contact(kin, self._tool_table_pairs)
            r = r + reach + torch.where(touching, cfg["wipe_contact_reward"], zero)
            press = (total_force > cfg["pressure_threshold"]) & touching & ~f_over
            r = r - torch.where(f_over, cfg["excess_force_penalty_mul"] * total_force, zero)
            r = r + torch.where(press, cfg["wipe_contact_reward"] + 0.01 * total_force, zero)
        r = r + torch.where(all_wiped, cfg["task_complete_reward"], zero)
        r = torch.where(unsafe, cfg["arm_limit_collision_penalty"] if self.reward_shaping else 0.0, r)
        if self.reward_scale is not None:
            denom = (self.num_markers * cfg["unit_wiped_reward"]
                     + self.horizon * (cfg["wipe_contact_reward"] + cfg["task_complete_reward"]))
            r = r * self.reward_scale * self.horizon / denom
        return r, f_over

    def reward(self, physics, kin):
        """The JAX base env's reward, which Wipe does not override: zero.
        step_batch replaces it (`_step_hook`); the planning return is zero."""
        return torch.zeros_like(kin.xpos[:, 0, 0])

    def _check_success(self, kin, task_state=None):
        """Every marker wiped; success lives in the task state."""
        if task_state is None:
            return torch.zeros(kin.xpos.shape[0], dtype=torch.bool, device=kin.xpos.device)
        return task_state.wiped.all(dim=-1)

    def _get_observations(self, physics, kin):
        robot = self.robots[0]
        qp = physics.qpos[:, robot.arm_qpos_idx["right"]]
        eef_pos = kin.site_xpos[:, self.eef_site]
        markers = self._marker_positions(kin)
        return {
            "robot0_joint_pos": qp,
            "robot0_joint_pos_cos": torch.cos(qp),
            "robot0_joint_pos_sin": torch.sin(qp),
            "robot0_joint_vel": physics.qvel[:, robot.arm_qvel_idx["right"]],
            "robot0_eef_pos": eef_pos,
            "robot0_eef_quat": T.mat2quat(kin.site_xmat[:, self.eef_site]),
            "marker_pos": markers,
            "marker_to_eef": markers - eef_pos[:, None],
        }
