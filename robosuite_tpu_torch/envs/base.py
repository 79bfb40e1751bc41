"""Environment base: the batched functional simulation API (the JAX
package's envs/base.py; robosuite environments/base.py, robot_env.py,
manipulation_env.py).

Everything is batched (batch is dim 0). A policy step is forward
products (K1), the policy-rate controller goals, 25 substeps of 2 ms —
each ONE launch of the fused substep kernel (K3) on CUDA — then the
end-of-step forward products (K1) and the reward. With `_disable_fused`
set, each substep instead runs forward products (K1), the controllers,
the contact rows and the contact-solve kernel (K2), as the JAX package's
unfused path does. The substep's index reaches the controllers: under
OSC's linear goal interpolation the fused kernel gets a goal row a
substep (resolved from the step's start poses, as the JAX goal_fn(k)),
the unfused law interpolates itself. `step_batch` is the RL entry point:
the step, then the observations through the Observable pipeline
(observables.py), with the
gripper's contact wrench from the last substep's solver forces, the
reward and `done` at the horizon; an env with a task state (Wipe) sets it
at the reset (`_reset_task_state`) and updates it after each step from the
step's end-of-step forward products (`_step_hook`), which may also replace
the reward, end episodes early, add observations and return info.
`rollout_batch` is the planners' lean step (no observations; the task
state carried unchanged). The MPC's planning hooks (`make_plan_return`,
`make_plan_dynamics`) run the same step on a planning model.

An env may hold several robots (the two-arm envs): each has its own
controller config, its slice of the action (in robot order) and its
controller state, and the controllers of all add into one ctrl vector per
substep. A robot's runtime follows its kind: FixedBaseRobot, or
MobileRobot / LeggedRobot for a wheeled or legged one, whose torso, head,
base and legs parts ride in the same controller state. The fused substep takes one single-arm robot; with more the
substeps run unfused, as the JAX package's do.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from robosuite_tpu_torch import macros
from robosuite_tpu_torch.controllers.parts import joint_pos as jp_mod
from robosuite_tpu_torch.controllers.parts import osc as osc_mod
from robosuite_tpu_torch.models.bases import REGISTERED_BASES, robot_base_factory
from robosuite_tpu_torch.models.grippers import REGISTERED_GRIPPERS, gripper_factory
from robosuite_tpu_torch.models.robots import create_robot
from robosuite_tpu_torch.observables import Observable, compute_observables, sensor
from robosuite_tpu_torch.ops.forward import runtime_leaves
from robosuite_tpu_torch.ops.substep import UnsupportedFused, make_fused_substep
from robosuite_tpu_torch.physics import contact as C
from robosuite_tpu_torch.physics import engine
from robosuite_tpu_torch.physics.state import KinData, State
from robosuite_tpu_torch.robots.robot import FixedBaseRobot, LeggedRobot, MobileRobot, RobotCtrlState

# the runtime class of each robot_kind (robosuite robots/__init__.py:15-34)
_RUNTIME = {"fixed": FixedBaseRobot, "wheeled": MobileRobot, "legged": LeggedRobot}

REGISTERED_ENVS: Dict[str, type] = {}


def register_env(cls):
    REGISTERED_ENVS[cls.__name__] = cls
    return cls


def make(env_name: str, *args, **kwargs):
    """robosuite environments/base.py:23-42. Runs on CUDA unless the caller
    passes device="cpu" (or another device)."""
    if env_name not in REGISTERED_ENVS:
        raise ValueError(f"unknown env {env_name}; known: {sorted(REGISTERED_ENVS)}")
    return REGISTERED_ENVS[env_name](*args, **kwargs)


@dataclasses.dataclass
class EnvState:
    """Batched env state: physics + controller + policy-step count."""

    physics: State
    ctrl: RobotCtrlState  # a tuple of them, in robot order, where the env has several robots
    t: torch.Tensor  # (B,) int
    obs_cache: dict = None  # the Observable pipeline's stale and delayed values, where any stage keeps them
    task_state: Any = None  # an env's own per-scenario state (Wipe's wiped markers), or None


def map_state(fn, state):
    """`fn` applied to every tensor of a nesting of dataclasses, dicts,
    tuples and lists (an EnvState, its tuple of controller states, a
    KinData), in a fixed order; None stays None."""
    if isinstance(state, torch.Tensor):
        return fn(state)
    if isinstance(state, dict):
        return {k: map_state(fn, v) for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return type(state)(map_state(fn, v) for v in state)
    if dataclasses.is_dataclass(state):
        return dataclasses.replace(state, **{f.name: map_state(fn, getattr(state, f.name))
                                             for f in dataclasses.fields(state)})
    return state


def _is_float32(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return dtype == torch.float32
    try:
        return np.dtype(dtype) == np.float32
    except TypeError:
        return False


def _ported(kind, name, registry):
    """name, where the port has that gripper or base; NotImplementedError
    naming it where it has not."""
    if name not in registry:
        raise NotImplementedError(f"{kind} {name!r} is not ported; the port has {sorted(registry)}")
    return name


class RobotEnv:
    """Host-side env handle: builds and compiles the world once."""

    def __init__(self, robots="Panda", controller_configs=None, control_freq=macros.DEFAULT_CONTROL_FREQ,
                 horizon=macros.DEFAULT_HORIZON, reward_scale=1.0, reward_shaping=False,
                 initialization_noise="default", use_camera_obs=False, camera_names=("agentview",),
                 camera_heights=84, camera_widths=84, camera_depths=False, gripper_types="default",
                 base_types="default", dtype=np.float32, device=None):
        if use_camera_obs:
            raise NotImplementedError("camera observations need the ray-cast renderer (the JAX package's "
                                      "renderers/raycast.py), which the port does not have yet")
        if not _is_float32(dtype):
            raise NotImplementedError(f"dtype={dtype!r}: the port builds float32 worlds only")
        self.camera_names = [camera_names] if isinstance(camera_names, str) else list(camera_names)
        self.camera_heights, self.camera_widths, self.camera_depths = camera_heights, camera_widths, camera_depths
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device: pass device='cpu' to run the port on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        self.robot_names = [robots] if isinstance(robots, str) else list(robots)
        self.control_freq = control_freq
        self.horizon = horizon
        self.reward_scale = reward_scale
        self.reward_shaping = reward_shaping
        self.n_substeps = int(round(1.0 / (control_freq * macros.SIMULATION_TIMESTEP)))
        if initialization_noise == "default":
            self.init_noise_mag = 0.02
        elif initialization_noise is None:
            self.init_noise_mag = 0.0
        else:
            self.init_noise_mag = float(initialization_noise.get("magnitude", 0.02))

        # the robot models, each with its base and grippers, named by its
        # index (the JAX envs/base.py:114-131): gripper_types and base_types
        # are "default" (each robot's own), one name (None: no gripper, the
        # NullMount) for every robot, or a list of one per robot
        def per_robot(spec, i):
            return spec[i] if isinstance(spec, (list, tuple)) else spec

        self.robot_models = []
        for i, name in enumerate(self.robot_names):
            rm = create_robot(name, idn=i)
            base_t = per_robot(base_types, i)
            bname = rm.default_base if base_t == "default" else "NullMount" if base_t is None else base_t
            rm.add_base(robot_base_factory(_ported("base", bname, REGISTERED_BASES), idn=i))
            grip_t = per_robot(gripper_types, i)
            for arm in rm.arms:
                gname = rm.default_gripper[arm] if grip_t == "default" else "NullGripper" if grip_t is None else grip_t
                rm.add_gripper(gripper_factory(_ported("gripper", gname, REGISTERED_GRIPPERS), idn=i, arm=arm), arm)
            self.robot_models.append(rm)
        self._load_model()
        self.model = self.task.compile().to(self.device)
        # one controller config for every robot, or a list of one per robot
        # (the JAX envs/base.py:137-151)
        cfgs = controller_configs if isinstance(controller_configs, (list, tuple)) else \
            [controller_configs] * len(self.robot_models)
        self.robots = [_RUNTIME[rm.robot_kind](self.model, rm, cfg) for rm, cfg in zip(self.robot_models, cfgs)]
        self._setup_references()
        lo, hi = self.action_spec
        self._action_lo = torch.as_tensor(lo, device=self.device)
        self._action_hi = torch.as_tensor(hi, device=self.device)
        self._fused_cache = {}
        self._obs_overrides = {}
        self._wrench_cache = {}

    # -- subclass hooks ------------------------------------------------------
    def _load_model(self):
        raise NotImplementedError

    def _setup_references(self):
        pass

    def reward(self, physics, kin):
        raise NotImplementedError

    def _sample_placements(self, generator, n):
        """-> (qpos indices, values (n, len)[, valid (n,) bool]) or None."""
        return None

    def _get_observations(self, physics, kin):
        return {}

    def _reset_task_state(self, n):
        """The task state of n fresh episodes (the JAX envs' _reset_impl
        overrides), or None."""
        return None

    def _step_hook(self, prev: "EnvState", new: "EnvState", obs, reward, done, kin):
        """After step_batch's base step (the JAX envs' _step_impl
        overrides): prev and new the states before and after, obs the
        observations through the pipeline, kin the end-of-step forward
        products. -> (new, obs, reward, done, info)."""
        return new, obs, reward, done, {}

    # -- contact queries (robosuite manipulation_env.py:331-376) -------------
    def _contact_pairs(self, geoms_a, geoms_b):
        """Candidate pairs between two geom name sets."""
        a, b = set(geoms_a), set(geoms_b)
        m = self.model
        out = []
        for k in range(m.npair):
            g1, g2 = m.geom_names[m.pair_geom1[k]], m.geom_names[m.pair_geom2[k]]
            if (g1 in a and g2 in b) or (g2 in a and g1 in b):
                out.append(k)
        return out

    def _any_contact(self, kin, pairs):
        """(B,) True where any point of the given pairs is touching (False
        for no pairs)."""
        if not pairs:
            return torch.zeros(kin.xpos.shape[0], dtype=torch.bool, device=kin.xpos.device)
        if kin.pair_dist is not None:
            return torch.any(kin.pair_dist[:, list(pairs)] < 0.0, dim=-1)
        con = C.narrowphase(self.model, kin, pairs=set(pairs))
        return torch.any(con["dist"] < 0.0, dim=-1)

    def grasp_pairs(self, arm, object_geoms, robot_idx=0):
        """(left fingerpad pairs, right fingerpad pairs) of robot
        `robot_idx`'s gripper on `arm` against the object's geoms (the JAX
        grasp_rows, by pair)."""
        grip = self.robot_models[robot_idx].grippers[arm]
        return (self._contact_pairs(grip.important_geoms["left_fingerpad"], object_geoms),
                self._contact_pairs(grip.important_geoms["right_fingerpad"], object_geoms))

    def check_grasp(self, kin, left_pairs, right_pairs):
        """Both fingerpads touching the object (manipulation_env.py:331-376)."""
        return self._any_contact(kin, left_pairs) & self._any_contact(kin, right_pairs)

    # -- the observation pipeline (the JAX envs/base.py:216-273; robosuite
    # utils/observables.py, environments/base.py:429-465): every raw key
    # gets an Observable (a clean passthrough unless modify_observable
    # overrides its stages), grouped by modality into "<modality>-state"
    def _default_modality(self, key):
        if key.endswith("_image") or key.endswith("_depth") or key == "placement_valid":
            return None  # outside the pipeline
        for i in range(len(self.robots)):
            if key.startswith(f"robot{i}_"):
                return f"robot{i}_proprio"
        return "object"

    def modify_observable(self, name, **overrides):
        """Override one observable's stages (robosuite environments/base.py
        modify_observable): corrupter=, filter=, delay=, update_every=,
        enabled=, active=."""
        self._obs_overrides.setdefault(name, {}).update(overrides)

    def _observables_for(self, raw_keys):
        specs = []
        for k in raw_keys:
            modality = self._default_modality(k)
            if modality is None:
                continue
            ov = self._obs_overrides.get(k, {})

            @sensor(modality)
            def read(ctx, key=k):
                return ctx[key]

            specs.append(Observable(name=k, sensor=read, corrupter=ov.get("corrupter"), filter=ov.get("filter"),
                                    delay=ov.get("delay", 0), update_every=ov.get("update_every", 1),
                                    enabled=ov.get("enabled", True), active=ov.get("active", True)))
        return specs

    def _finalize_observations(self, obs, generator, t, cache=None):
        """The raw obs dict through the pipeline: -> (obs with the piped
        values and the '<modality>-state' vectors, the new cache, or None
        where no stage keeps state)."""
        specs = self._observables_for(list(obs))
        piped, new_cache = compute_observables(specs, obs, generator, t, cache=cache)
        out = dict(obs)
        out.update(piped)
        needs_cache = any(s.delay > 0 or s.update_every > 1 for s in specs)
        return out, (new_cache if needs_cache else None)

    # -- the gripper's contact wrench (the JAX envs/base.py:341-437)
    def _subtree_bodies(self, root_body):
        """The bodies in root_body's subtree, itself included."""
        m, out = self.model, []
        for b in range(m.nbody):
            k = b
            while True:
                if k == root_body:
                    out.append(b)
                    break
                if k == 0:
                    break
                k = m.body_parentid[k]
        return out

    def _wrench_rows(self, subtree):
        """[(row, sign, pair)]: the contact rows with exactly one side in
        `subtree`; sign +1 where body2 is that side (the row's force acts on
        the subtree along +normal)."""
        sub, m = set(subtree), self.model
        layout = C.contact_row_layout(m)
        out = []
        for k in range(m.npair):
            b1, b2 = m.geom_bodyid[m.pair_geom1[k]], m.geom_bodyid[m.pair_geom2[k]]
            if (b1 in sub) == (b2 in sub):
                continue
            out += [(r, 1.0 if b2 in sub else -1.0, k) for r in layout[k]]
        return out

    def _wrench_plan(self, robot_idx, arm):
        """Per (robot, arm), computed once: (eef site, the subset's pairs,
        the rows of the pairs' own narrowphase, the full-buffer rows, signs
        (R,), the buffer's row count)."""
        key = (robot_idx, arm)
        if key not in self._wrench_cache:
            m = self.model
            site = self.robots[robot_idx].eef_site_id[arm]
            root = k = m.site_bodyid[site]
            while k != 0:  # the highest gripper body above the eef site
                if m.body_names[k].startswith(f"gripper{robot_idx}_"):
                    root = k
                k = m.body_parentid[k]
            rows = self._wrench_rows(self._subtree_bodies(root))
            layout = C.contact_row_layout(m)
            pairs = sorted({k for _, _, k in rows}, key=lambda k: layout[k][0])
            sub_row = {r: i for i, r in enumerate(r for k in pairs for r in layout[k])}
            dev = self.device
            self._wrench_cache[key] = (
                site, set(pairs), torch.tensor([sub_row[r] for r, _, _ in rows], dtype=torch.long, device=dev),
                torch.tensor([r for r, _, _ in rows], dtype=torch.long, device=dev),
                torch.tensor([s for _, s, _ in rows], dtype=torch.float32, device=dev),
                sum(len(v) for v in layout.values()))
        return self._wrench_cache[key]

    def eef_contact_wrench(self, kin, f, robot_idx, arm):
        """(force (B, 3), torque (B, 3)) of the contact forces on the
        subtree of robot `robot_idx`'s gripper on `arm` about its eef site
        (the JAX envs/base.py:376-411): robosuite's eef force/torque
        sensors (robots/robot.py:795-814) from the last substep's solver
        forces f (B, 3R), rows [normals | t1 | t2] in the static row layout,
        and the rows' frames from the end-of-step narrowphase of the
        gripper's pairs (plain torch code). Gravity and inertial terms are
        not included."""
        site, pairs, ridx, fidx, signs, R = self._wrench_plan(robot_idx, arm)
        B = kin.site_xpos.shape[0]
        zero = torch.zeros(B, 3, dtype=kin.site_xpos.dtype, device=kin.site_xpos.device)
        if not pairs:
            return zero, zero
        con = C.narrowphase(self.model, kin, pairs=pairs)
        fw = (con["normal"][:, ridx] * f[:, fidx, None] + con["t1"][:, ridx] * f[:, R + fidx, None]
              + con["t2"][:, ridx] * f[:, 2 * R + fidx, None]) * signs[:, None]
        arm_ = con["pos"][:, ridx] - kin.site_xpos[:, site, None]
        return fw.sum(dim=1), torch.linalg.cross(arm_, fw).sum(dim=1)

    def _wrench_obs(self, obs, kin, f):
        """Add robot{i}_eef_force and robot{i}_eef_torque of every robot i
        (robot{i}_{arm}_eef_* for a second arm; the JAX envs/base.py:514-519,
        824-828); f None: zero forces (the reset). Zero too on a world that
        compacts its rows (the JAX package's envs/base.py:408-411): f's
        slots there follow the active rows, not the static layout."""
        zero = f is None or C.uses_row_compaction(self.model)
        for i, robot in enumerate(self.robots):
            for arm in robot.arms:
                p = f"robot{i}_" + ("" if arm == "right" or len(robot.arms) == 1 else f"{arm}_")
                if zero:
                    obs[f"{p}eef_force"] = obs[f"{p}eef_torque"] = torch.zeros_like(kin.site_xpos[:, 0])
                else:
                    obs[f"{p}eef_force"], obs[f"{p}eef_torque"] = self.eef_contact_wrench(kin, f, i, arm)
        return obs

    # -- action space: the robots' actions concatenated in robot order -------
    @property
    def action_dim(self) -> int:
        return sum(r.action_dim for r in self.robots)

    @property
    def action_spec(self):
        """Per-dim bounds: [-1, 1], but a variable-impedance arm's gains and
        damping ratios carry their limits (robosuite env_base action_spec)."""
        lims = [r.action_limits for r in self.robots]
        return np.concatenate([lo for lo, _ in lims]), np.concatenate([hi for _, hi in lims])

    def _split_robot_actions(self, action):
        """Each robot's slice of the (B, action_dim) actions (the JAX
        envs/base.py:553-559)."""
        out, i = [], 0
        for r in self.robots:
            out.append(action[:, i:i + r.action_dim])
            i += r.action_dim
        return out

    def _pack_ctrl(self, ctrl_states):
        """The EnvState's ctrl: the one robot's state, or a tuple of them
        (the JAX envs/base.py:543-551)."""
        return ctrl_states[0] if len(ctrl_states) == 1 else tuple(ctrl_states)

    def _unpack_ctrl(self, ctrl):
        return [ctrl] if len(self.robots) == 1 else list(ctrl)

    def _init_ctrl(self, kin, M, bias, qpos, qvel):
        return self._pack_ctrl([r.init_ctrl_state(kin, M, bias, qpos, qvel) for r in self.robots])

    def _set_goals(self, kin, M, bias, qpos, qvel, ctrl, action):
        """Every robot's policy-rate goals from its slice of the action."""
        return self._pack_ctrl([r.set_goals(kin, M, bias, qpos, qvel, cs, a) for r, cs, a in
                                zip(self.robots, self._unpack_ctrl(ctrl), self._split_robot_actions(action))])

    # -- core API ----------------------------------------------------------------
    def _initial_qpos(self, n, generator):
        """qpos0 with each robot's init_qpos plus noise (drawn robot by
        robot), the torso's init posture (its last joints, no noise), a leg
        base's standing posture (Spot's, robosuite spot_base.py:26-28) and
        its grippers' init_qpos (the JAX envs/base.py:467-495)."""
        gdev = generator.device
        qpos = self.model.qpos0.expand(n, -1).clone()
        for robot, rm in zip(self.robots, self.robot_models):
            iq = torch.as_tensor(np.asarray(rm.init_qpos, dtype=np.float32), device=gdev)
            noise = self.init_noise_mag * torch.randn(n, iq.shape[0], generator=generator, device=gdev)
            qpos[:, robot.init_qpos_idx] = (iq + noise).to(self.device)
            if rm.init_torso_qpos is not None:  # a mobile robot's
                itq = np.asarray(rm.init_torso_qpos, dtype=np.float32)
                qpos[:, robot.part_qpos_idx["torso"][-len(itq):]] = torch.as_tensor(itq, device=self.device)
            if rm.base.leg_joints:
                lidx = [self.model.jnt_qposadr[self.model.jnt_name2id(j)] for j in rm.base.leg_joints]
                qpos[:, lidx] = torch.as_tensor(np.asarray(rm.base.init_qpos, dtype=np.float32)[:len(lidx)],
                                                device=self.device)
            for arm in robot.arms:
                gi = torch.as_tensor(np.asarray(rm.grippers[arm].init_qpos, dtype=np.float32), device=self.device)
                qpos[:, robot.gripper_joint_qpos_idx[arm]] = gi
        return qpos

    def reset_batch(self, n: int, generator: torch.Generator):
        """n fresh episodes (the JAX _reset_impl): -> (EnvState, observation
        dict through the pipeline, the eef force and torque at zero). The
        dict carries "placement_valid" (n,), as the JAX reset does for every
        env: False where an object found no free spot (robosuite raises
        RandomizationError there), all True where the env's sampler reports
        no validity. Noise corrupters draw from `generator` after the
        initial pose and the placements."""
        qpos = self._initial_qpos(n, generator)
        placement = self._sample_placements(generator, n)
        valid = None
        if placement is not None:
            idx, vals, *valid = placement
            qpos[:, idx] = vals.to(self.device)
        zeros = torch.zeros(n, dtype=qpos.dtype, device=self.device)
        physics = State(qpos=qpos, qvel=torch.zeros(n, self.model.nv, device=self.device), time=zeros)
        kin, M, bias = engine.forward_products(self.model, physics.qpos, physics.qvel)
        ctrl = self._init_ctrl(kin, M, bias, physics.qpos, physics.qvel)
        t = torch.zeros(n, dtype=torch.int32, device=self.device)
        obs = self._wrench_obs(self._get_observations(physics, kin), kin, None)
        obs["placement_valid"] = (valid[0].to(self.device) if valid
                                  else torch.ones(n, dtype=torch.bool, device=self.device))
        obs, cache = self._finalize_observations(obs, generator, t)
        return EnvState(physics=physics, ctrl=ctrl, t=t, obs_cache=cache, task_state=self._reset_task_state(n)), obs

    def state_from_flattened(self, flat):
        """EnvState from flattened (time, qpos, qvel) rows (B, 1 + nq + nv)
        (robosuite set_state_from_flattened + controller reset)."""
        flat = torch.tensor(np.asarray(flat), dtype=torch.float32, device=self.device)
        physics = State.from_flattened(flat, self.model)
        physics = State(qpos=physics.qpos.contiguous(), qvel=physics.qvel.contiguous(), time=physics.time)
        kin, M, bias = engine.forward_products(self.model, physics.qpos, physics.qvel)
        ctrl = self._init_ctrl(kin, M, bias, physics.qpos, physics.qvel)
        return EnvState(physics=physics, ctrl=ctrl,
                        t=torch.zeros(flat.shape[0], dtype=torch.int32, device=self.device))

    def _fused_for(self, model, emit_aux=False):
        """The fused-substep wrapper for `model`, or None where the
        reference runs unfused (UnsupportedFused; any other refusal raises).
        Keyed by model identity; the cache holds the model, so an id is
        never reused while its entry lives."""
        key = (id(model), emit_aux)
        if key not in self._fused_cache:
            try:
                fn = make_fused_substep(self, model, emit_aux=emit_aux)
            except UnsupportedFused:
                fn = None
            self._fused_cache[key] = (model, fn)
        return self._fused_cache[key][1]

    def _fused_goal_fn(self, robot, arm, ctrl_state, kin, k=None):
        """(goal, gains) rows for the fused kernel at substep k of the policy
        step (the JAX goal_fn(k)): OSC, the goal in the world frame (B, 12)
        from the origin pose in kin, the one at the step's start, interpolated
        at k under interpolation="linear" (k None: the goal itself), and [kp,
        kd] (B, 12); JOINT_POSITION, goal_qpos (B, na) and [kp, kd] (B, 2 na)."""
        cfg = robot.arm_cfg[arm]
        st = ctrl_state.arm[arm]
        gains = torch.cat([st.kp, st.kd], dim=-1).contiguous()
        if isinstance(cfg, jp_mod.JointPosConfig):
            return st.goal_qpos.contiguous(), gains
        cen = robot.center_site_id[arm]
        despos, desori = osc_mod.desired_world_pose(cfg, st, kin.site_xpos[:, cen], kin.site_xmat[:, cen], k)
        B = despos.shape[0]
        return torch.cat([despos, desori.reshape(B, 9)], dim=-1).contiguous(), gains

    def _fused_goals(self, robot, arm, ctrl_state, kin):
        """goal_at(k) -> (goal, gains) of substep k (None: the goal itself):
        resolved once a policy step, or, under OSC's goal interpolation, once
        for each of the interp_steps substeps whose goal differs (the goal
        stays at the ramp's end from there)."""
        cfg = robot.arm_cfg[arm]
        if getattr(cfg, "interpolation", None) != "linear":
            rows = self._fused_goal_fn(robot, arm, ctrl_state, kin)
            return lambda k: rows
        cache = {}

        def goal_at(k):
            k = None if k is None else min(k, cfg.interp_steps - 1)
            if k not in cache:
                cache[k] = self._fused_goal_fn(robot, arm, ctrl_state, kin, k)
            return cache[k]

        return goal_at

    def _fused_substep_fn(self, model, ctrl_state, kin):
        """substep(physics, k) -> (physics, f) using the fused kernel at
        substep k of the policy step, or None (the gate refuses an env with
        more than one robot, so ctrl_state is the one robot's); f (B, 3R) is
        the substep's solver forces in the static row layout."""
        if getattr(self, "_disable_fused", False):
            return None
        fused = self._fused_for(model)
        if fused is None:
            return None
        robot = self.robots[0]
        arm = robot.arms[0]
        goal_at = self._fused_goals(robot, arm, ctrl_state, kin)
        grip = robot.gripper_ctrl(arm, ctrl_state).contiguous()
        leaves = runtime_leaves(model, kin.site_xpos.shape[0])

        def substep(phys, k=None):
            goal, gains = goal_at(k)
            qpos, qvel, f = fused(phys.qpos, phys.qvel, *leaves, goal, gains, grip)
            return State(qpos=qpos, qvel=qvel, time=phys.time + model.timestep), f

        return substep

    def run_controllers(self, kin, M, bias, qpos, qvel, ctrl, substep=None):
        """The substep-rate ctrl (B, nu): every robot's torques and gripper
        ctrl written into one vector (the JAX envs/base.py:876-881);
        `substep`, the index within the policy step, drives OSC's goal
        interpolation."""
        c = torch.zeros(qpos.shape[0], self.model.nu, dtype=qpos.dtype, device=qpos.device)
        for robot, cs in zip(self.robots, self._unpack_ctrl(ctrl)):
            c = robot.run_controllers(kin, M, bias, qpos, qvel, cs, c, substep)
        return c

    def _substep_fn(self, model, ctrl_state, kin):
        """substep(physics, k) -> (physics, f) at substep k of the policy
        step: the fused kernel, or (unsupported or `_disable_fused`) forward
        products + controllers + contact solve. Both give f in the static
        row layout [normals | t1 | t2]."""
        substep = self._fused_substep_fn(model, ctrl_state, kin)
        if substep is not None:
            return substep

        def substep(phys, k=None):
            kk, Mk, bk = engine.forward_products(model, phys.qpos, phys.qvel)
            c = self.run_controllers(kk, Mk, bk, phys.qpos, phys.qvel, ctrl_state, k)
            return engine.integrate(model, phys, c, kk, Mk, bk)

        return substep

    def _physics_step(self, state: EnvState, action, model, n_substeps, kin, M, bias):
        """The goals and n_substeps substeps from the start-of-step forward
        products: -> (physics', ctrl', the last substep's f)."""
        physics = state.physics
        ctrl = self._set_goals(kin, M, bias, physics.qpos, physics.qvel, state.ctrl, action)
        substep = self._substep_fn(model, ctrl, kin)
        f = None
        for k in range(n_substeps):
            physics, f = substep(physics, k)
        return physics, ctrl, f

    def _rollout_with_products(self, state: EnvState, action, model, n_substeps, kin, M, bias):
        """One policy step given the start-of-step forward products; returns
        (state', reward, end-of-step products)."""
        physics, ctrl, _ = self._physics_step(state, action, model, n_substeps, kin, M, bias)
        kin2, M2, bias2 = engine.forward_products(model, physics.qpos, physics.qvel)
        reward = self.reward(physics, kin2)
        return (EnvState(physics=physics, ctrl=ctrl, t=state.t + 1, task_state=state.task_state), reward,
                (kin2, M2, bias2))

    def rollout_batch(self, states: EnvState, actions):
        """Batched policy step (the JAX _rollout_impl): -> (states', rewards)."""
        actions = self._clip(torch.as_tensor(actions, dtype=torch.float32, device=self.device))
        kin, M, bias = engine.forward_products(self.model, states.physics.qpos, states.physics.qvel)
        new, reward, _ = self._rollout_with_products(states, actions, self.model, self.n_substeps, kin, M, bias)
        return new, reward

    def step_batch(self, states: EnvState, actions, generator: torch.Generator = None):
        """Batched policy step (the JAX _step_impl / step_batch): goals,
        substeps, the end-of-step forward products, the observations through
        the pipeline (with the eef wrench of the last substep's solver
        forces), the reward, then done = t >= horizon, then the env's
        `_step_hook`. -> (states', obs, reward (B,), done (B,) bool, info
        dict). Noise corrupters draw from `generator`."""
        actions = self._clip(torch.as_tensor(actions, dtype=torch.float32, device=self.device))
        model = self.model
        kin, M, bias = engine.forward_products(model, states.physics.qpos, states.physics.qvel)
        physics, ctrl, f = self._physics_step(states, actions, model, self.n_substeps, kin, M, bias)
        kin2 = engine.forward_products(model, physics.qpos, physics.qvel)[0]
        obs = self._wrench_obs(self._get_observations(physics, kin2), kin2, f)
        obs, cache = self._finalize_observations(obs, generator, states.t, cache=states.obs_cache)
        reward = self.reward(physics, kin2)
        t = states.t + 1
        done = t >= self.horizon
        new = EnvState(physics=physics, ctrl=ctrl, t=t, obs_cache=cache, task_state=states.task_state)
        return self._step_hook(states, new, obs, reward, done, kin2)

    # -- MPC planning hooks (the JAX envs/base.py make_plan_return / make_plan_dynamics)
    def _clip(self, actions):
        return torch.clamp(actions, self._action_lo, self._action_hi)

    def _kin_lite(self, model, site_xpos, site_xmat, xpos, pair_dist):
        """KinData carrying what the planning rollout's goals and reward
        read (site poses, body positions, per-pair distances); the motion
        subspace is zero and the geom poses NaN, so a consumer it does not
        track shows at once."""
        B, dt, dev = xpos.shape[0], xpos.dtype, xpos.device

        def const(v, *shape):
            return torch.full((1,) * (len(shape) + 1), v, dtype=dt, device=dev).expand(B, *shape)

        nb, nv, ng = model.nbody, model.nv, model.ngeom
        return KinData(xpos=xpos, xquat=const(0.0, nb, 4), xmat=const(0.0, nb, 3, 3), xipos=const(0.0, nb, 3),
                       ximat=const(0.0, nb, 3, 3), sdof_ang=const(0.0, nv, 3), sdof_lin=const(0.0, nv, 3),
                       geom_xpos=const(float("nan"), ng, 3), geom_xmat=const(float("nan"), ng, 3, 3),
                       site_xpos=site_xpos, site_xmat=site_xmat, pair_dist=pair_dist)

    def make_plan_return(self, model, n_substeps):
        """rollout_return(states, seqs, discounts) -> (N,) discounted
        return of each action sequence seqs (N, H, A) from each state, on
        the planning `model` with `n_substeps` substeps per planned step.

        Fused form (the kernel covers the world): one forward-products
        launch (K1) for the start poses, then per planned step the
        policy-rate goals and n_substeps launches of the emit_aux fused
        substep, whose post-step site poses, body positions and pair
        distances feed the reward and the next step's goals. Otherwise (or
        with `_disable_fused`) the product-carrying policy steps (every
        env with several robots)."""
        fused = None if getattr(self, "_disable_fused", False) else self._fused_for(model, emit_aux=True)
        robot = self.robots[0]
        arm = robot.arms[0]

        def rollout_unfused(state, seqs, discounts):
            kin, M, bias = engine.forward_products(model, state.physics.qpos, state.physics.qvel)
            rewards = []
            for h in range(seqs.shape[1]):
                state, r, (kin, M, bias) = self._rollout_with_products(
                    state, self._clip(seqs[:, h]), model, n_substeps, kin, M, bias)
                rewards.append(r)
            return (torch.stack(rewards, dim=-1) * discounts).sum(dim=-1)

        def rollout_fused(state, seqs, discounts):
            physics, ctrl = state.physics, state.ctrl
            N = seqs.shape[0]
            kin0 = engine.forward_products(model, physics.qpos, physics.qvel)[0]
            aux = (kin0.site_xpos, kin0.site_xmat, kin0.xpos,
                   torch.zeros(N, model.npair, dtype=physics.qpos.dtype, device=physics.qpos.device))
            leaves = runtime_leaves(model, N)
            M0 = torch.zeros((1, 1, 1), dtype=physics.qpos.dtype, device=physics.qpos.device).expand(
                N, model.nv, model.nv)
            b0 = M0[:, 0]
            qpos, qvel, time = physics.qpos.contiguous(), physics.qvel.contiguous(), physics.time
            rewards = []
            for h in range(seqs.shape[1]):
                kl = self._kin_lite(model, *aux)
                ctrl = robot.set_goals(kl, M0, b0, qpos, qvel, ctrl, self._clip(seqs[:, h]))
                goal_at = self._fused_goals(robot, arm, ctrl, kl)
                grip = robot.gripper_ctrl(arm, ctrl).contiguous()
                for k in range(n_substeps):
                    qpos, qvel, _f, *aux = fused(qpos, qvel, *leaves, *goal_at(k), grip)
                    time = time + model.timestep
                rewards.append(self.reward(State(qpos=qpos, qvel=qvel, time=time), self._kin_lite(model, *aux)))
            return (torch.stack(rewards, dim=-1) * discounts).sum(dim=-1)

        return rollout_unfused if fused is None else rollout_fused

    def make_plan_dynamics(self, model, n_substeps):
        """dyn(states, actions) -> states' for the MPC's linearization and
        line search: the policy-rate goals and n_substeps substeps on
        `model`, with no reward and no end-of-step forward products (the
        linearizer reads only the next state). Fused: one K1 launch, then
        n_substeps fused-substep launches."""

        def dyn(state, action):
            physics = state.physics
            kin, M, bias = engine.forward_products(model, physics.qpos, physics.qvel)
            physics, ctrl, _ = self._physics_step(state, self._clip(action), model, n_substeps, kin, M, bias)
            return EnvState(physics=physics, ctrl=ctrl, t=state.t + 1, task_state=state.task_state)

        return dyn

