"""Composite controllers (the JAX package's
controllers/composite/composite_controller.py; robosuite
controllers/composite/composite_controller.py).

A composite controller owns one robot's part controllers and splits the
flat action into their slices (setup_action_split_idx, :86-95). The runtime
robots (robots/robot.py) run that flow; this module holds the registry, the
third-party registration and the spec object that states the split as data,
from which each runtime robot takes its action layout:

  * BASIC (:30-231): arms, then the mobile parts, then the grippers;
  * HYBRID_MOBILE_BASE (:234-291): BASIC plus a trailing base-mode dim,
    which switches the arms' OSC goals to the origin-referenced frame while
    the base moves (MobileRobot.set_goals);
  * WHOLE_BODY_IK (:514-589): one 6-wide task-space target per arm, solved
    jointly over the torso and arms (composite/wbik.py) into
    JOINT_POSITION goals; WHOLE_BODY_MINK_IK maps onto it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

from robosuite_tpu_torch.controllers.factory import arm_controller_config

REGISTERED_COMPOSITE_CONTROLLERS = ("BASIC", "HYBRID_MOBILE_BASE", "WHOLE_BODY_IK")


@dataclasses.dataclass(frozen=True)
class ThirdPartyComposite:
    """A registered third-party composite controller (robosuite
    @register_composite_controller, composite_controller.py:15-27).

    goal_fn(robot, kin, qpos, qvel, targets, cfg) -> {part: goal_qpos (B, n)}
    runs at policy rate: targets {arm: (B, arm_action_dim) action slice},
    cfg the composite_controller_specific_configs dict. Each arm's
    JOINT_POSITION part controller (kp 1000, absolute goals) tracks the
    goals."""

    name: str
    goal_fn: Callable
    arm_action_dim: int = 6


THIRD_PARTY_COMPOSITE_CONTROLLERS: Dict[str, ThirdPartyComposite] = {}


def register_composite_controller(name: str, arm_action_dim: int = 6):
    """Decorator registering a goal transform under `name`, then usable as
    controller_configs={"type": name, ...}."""

    def deco(fn):
        THIRD_PARTY_COMPOSITE_CONTROLLERS[name] = ThirdPartyComposite(name=name, goal_fn=fn,
                                                                      arm_action_dim=arm_action_dim)
        return fn

    return deco


@dataclasses.dataclass(frozen=True)
class CompositeControllerSpec:
    """A robot's composite controller as data: the runtime robots
    (robots/robot.py) read their action layout off it."""

    type: str                       # BASIC | HYBRID_MOBILE_BASE | WHOLE_BODY_IK | a third-party name
    arm_configs: Dict[str, object]  # arm -> part-controller config
    gripper_dims: Dict[str, int]    # arm -> gripper dof
    # torso / head / base / legs -> control dim (mobile_robot.py:42-187)
    part_dims: Dict[str, int] = dataclasses.field(default_factory=dict)
    # arm -> action width where it is not the part controller's: a
    # whole-body composite's task-space target
    arm_action_dims: Dict[str, int] = dataclasses.field(default_factory=dict)

    def _layout(self) -> List[Tuple[str, str, int]]:
        """[(part, kind, width)] in action order, a gripper with no dof
        included at its place with width 0."""
        out = [(arm, "arm", self.arm_action_dims.get(arm, cfg.control_dim)) for arm, cfg in self.arm_configs.items()]
        out += [(p, "mobile", self.part_dims[p]) for p in ("torso", "head", "base", "legs")
                if self.part_dims.get(p, 0) > 0]
        out += [(f"{arm}_gripper", "gripper", self.gripper_dims.get(arm, 0)) for arm in self.arm_configs]
        if self.type == "HYBRID_MOBILE_BASE":
            out.append(("base_mode", "mode", 1))
        return out

    @property
    def action_split(self) -> List[Tuple[str, str, int]]:
        """[(part, kind, width)] in action order: arms, the mobile parts,
        grippers, and HYBRID_MOBILE_BASE's trailing base_mode."""
        return [entry for entry in self._layout() if entry[1] != "gripper" or entry[2] > 0]

    @property
    def action_dim(self) -> int:
        return sum(w for _, _, w in self.action_split)

    def split_indexes(self) -> Dict[str, Tuple[int, int]]:
        """part -> (start, end) in action order; a gripper with no dof keeps
        an empty slice (the JAX robots' action_split_indexes)."""
        out, i = {}, 0
        for name, _, w in self._layout():
            out[name] = (i, i + w)
            i += w
        return out


def make_composite(ctype: str = "BASIC", arms=("right",), gripper_dims=None, arm_type="OSC_POSE", part_dims=None,
                   **overrides):
    """A CompositeControllerSpec (robosuite composite_controller_factory.py
    :73-140): WHOLE_BODY_IK takes IK_POSE arms, the others `arm_type`."""
    if ctype not in REGISTERED_COMPOSITE_CONTROLLERS:
        raise ValueError(f"unknown composite {ctype!r}; known: {REGISTERED_COMPOSITE_CONTROLLERS}")
    part_type = "IK_POSE" if ctype == "WHOLE_BODY_IK" else arm_type
    return CompositeControllerSpec(
        type=ctype, arm_configs={arm: arm_controller_config(part_type, **overrides) for arm in arms},
        gripper_dims=gripper_dims or {arm: 1 for arm in arms}, part_dims=dict(part_dims or {}))
