"""Controller config resolution (the JAX package's controllers/factory.py;
robosuite controller_factory.py and composite_controller_factory.py):
the BASIC, HYBRID_MOBILE_BASE and WHOLE_BODY_IK composites (and
WHOLE_BODY_MINK_IK, which maps onto WHOLE_BODY_IK) and registered
third-party ones, with any of the six part controllers on the arms and
the torso / head / base / legs parts of a mobile or legged robot.

Search order as in robosuite: an explicit dict, a composite name
(config/default/composite/<name>.json), the per-robot default
(config/robots/default_<robot>.json); a part-controller name ("IK_POSE")
takes the JAX factory's defaults for that type, and
`load_part_controller_config` reads robosuite's part JSONs
(config/default/parts/<name>.json).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Union

from robosuite_tpu_torch.controllers.parts import ik as ik_mod
from robosuite_tpu_torch.controllers.parts import joint_pos as jp_mod
from robosuite_tpu_torch.controllers.parts import joint_tor as jt_mod
from robosuite_tpu_torch.controllers.parts import joint_vel as jv_mod
from robosuite_tpu_torch.controllers.parts import osc as osc_mod

_CFG_ROOT = os.path.join(os.path.dirname(__file__), "config")

ALL_PART_CONTROLLERS = {"OSC_POSE", "OSC_POSITION", "JOINT_POSITION", "JOINT_VELOCITY", "JOINT_TORQUE", "IK_POSE"}

# the JAX factory's defaults of each type (robosuite config/default/composite/
# basic.json for OSC): a config class and the fields it sets over the class's
_OSC_DEFAULTS = dict(damping_ratio_limits=(0.0, 10.0))
_DEFAULTS = {
    "OSC_POSE": (osc_mod.OSCConfig, dict(_OSC_DEFAULTS, control_ori=True)),
    "OSC_POSITION": (osc_mod.OSCConfig, dict(_OSC_DEFAULTS, control_ori=False, output_max=(0.05, 0.05, 0.05),
                                             output_min=(-0.05, -0.05, -0.05))),
    "JOINT_POSITION": (jp_mod.JointPosConfig, dict(input_max=1.0, input_min=-1.0, output_max=0.05, output_min=-0.05,
                                                   kp=50.0)),
    "JOINT_VELOCITY": (jv_mod.JointVelConfig, dict(input_max=1.0, input_min=-1.0, output_max=1.0, output_min=-1.0,
                                                   kp=0.25)),
    "IK_POSE": (ik_mod.IKConfig, {}),
    "JOINT_TORQUE": (jt_mod.JointTorConfig, dict(input_max=1.0, input_min=-1.0, output_max=0.05, output_min=-0.05)),
}


def arm_controller_config(ctrl_type: str, dim: int = 7, **overrides):
    """A part-controller config dataclass (robosuite controller_factory.py
    arm_controller_factory) with the JAX factory's defaults. OSC's
    control_ori follows the type name (OSC_POSE or OSC_POSITION) whatever
    the overrides say; keys the dataclass has no field for (kd/kv or
    qpos_limits of the reference JSON) are dropped, lists become tuples."""
    t = ctrl_type.upper()
    if t not in _DEFAULTS:
        raise ValueError(f"unknown controller type {ctrl_type!r}; known: {sorted(ALL_PART_CONTROLLERS)}")
    cls, kw = _DEFAULTS[t]
    kw = dict(kw)
    if cls is not osc_mod.OSCConfig:
        kw["dim"] = dim
    fields = {f.name for f in dataclasses.fields(cls)} - {"control_ori"}
    kw.update({k: tuple(v) if isinstance(v, list) else v for k, v in overrides.items() if k in fields})
    return cls(**kw)


def load_part_controller_config(name: str) -> dict:
    """robosuite's part-controller JSON for a type name
    (config/default/parts/<name>.json), a dict with its "type"."""
    with open(os.path.join(_CFG_ROOT, "default", "parts", name.lower() + ".json")) as f:
        return json.load(f)


def robot_config_name(robot: str) -> str:
    """The per-robot config file's stem (robosuite
    composite_controller_factory.py _get_robot_name): robot variants share
    one default file."""
    for key, stem in (("GR1FloatingBody", "gr1_floating_body"), ("GR1FixedLowerBody", "gr1_fixed_lower_body"),
                      ("GR1", "gr1"), ("PandaDex", "panda_dex"), ("SpotWithArm", "spotwitharm")):
        if key in robot:
            return stem
    return robot.lower()


def resolve_controller_json(controller: Union[None, str, dict], robot: Optional[str]) -> Optional[dict]:
    if isinstance(controller, dict):
        return controller
    if isinstance(controller, str):
        path = controller if controller.endswith(".json") else os.path.join(
            _CFG_ROOT, "default", "composite", controller.lower() + ".json")
    else:
        path = os.path.join(_CFG_ROOT, "robots", f"default_{robot_config_name(robot)}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _body_part_config(cfg: dict, dim: int = 7):
    """One arm's entry of a composite JSON's body_parts as the JAX factory
    flattens it: goal interpolation is kept for the OSC types only, and
    only where it is set; the limits and the gripper are dropped. A joint
    type's width is the arm's joint count `dim` (the JAX factory leaves it
    at 7, which a 6-joint arm cannot run)."""
    cfg = dict(cfg)
    t = cfg.pop("type")
    cfg.pop("gripper", None)
    if not t.upper().startswith("OSC") or cfg.get("interpolation", "linear") is None:
        cfg.pop("interpolation", None)
        cfg.pop("ramp_ratio", None)
    cfg.pop("position_limits", None)
    cfg.pop("orientation_limits", None)
    return arm_controller_config(t, dim=dim, **cfg)


def load_composite_controller_config(controller=None, robot: Optional[str] = None, arms=("right",), dims=None):
    """Resolve to {arm: a part-controller config}; dims {arm: joint count}
    sizes the joint-space types (default 7). `controller` may also be a
    dict of part configs by arm, {"right": {"type": "OSC_POSE",
    "impedance_mode": "variable_kp"}} (the JAX factory's form), which is
    not modified."""
    dims = dims or {}
    if isinstance(controller, dict) and "body_parts" not in controller and "type" not in controller:
        out = {}
        for arm, cfg in controller.items():
            cfg = dict(cfg)
            out[arm] = arm_controller_config(cfg.pop("type"), **{"dim": dims.get(arm, 7), **cfg})
        return out
    resolved = resolve_controller_json(controller, robot)
    if resolved is None:
        name = controller if isinstance(controller, str) else "OSC_POSE"
        return {arm: arm_controller_config(name, dim=dims.get(arm, 7)) for arm in arms}
    return {arm: _body_part_config(resolved["body_parts"]["arms"][arm], dims.get(arm, 7)) for arm in arms}


@dataclasses.dataclass
class CompositeResolution:
    """What a robot's controller config resolves to (the JAX
    robots/robot.py:123-205)."""

    type: Optional[str]           # the composite type (None: none named; the robot's default then)
    json: Optional[dict]          # the resolved JSON with body_parts, whose torso / head / legs entries the parts read
    arm_cfg: dict                 # arm -> part-controller config
    wbik: Optional[dict] = None   # WHOLE_BODY_IK's composite_controller_specific_configs
    custom: Optional[tuple] = None  # (ThirdPartyComposite, its specific configs)


def _tracking_arms(dims):
    """Each arm's JOINT_POSITION tracker of a whole-body composite's
    joint goals: kp 1000, absolute input."""
    return {arm: arm_controller_config("JOINT_POSITION", dim=n, kp=1000.0, input_type="absolute")
            for arm, n in dims.items()}


def resolve_composite(controller, robot: str, dims) -> CompositeResolution:
    """Resolve a robot's controller config: a name, a path or None (the
    per-robot default JSON first, as robosuite searches), a composite dict,
    or a dict of part configs by arm. dims {arm: joint count}, in arm
    order. WHOLE_BODY_MINK_IK runs as WHOLE_BODY_IK with its posture
    weights as the nullspace weights; a registered third-party type takes
    JOINT_POSITION trackers on the arms, as does WHOLE_BODY_IK without
    body_parts."""
    from robosuite_tpu_torch.controllers.composite.composite_controller import (
        REGISTERED_COMPOSITE_CONTROLLERS, THIRD_PARTY_COMPOSITE_CONTROLLERS)

    arms = list(dims)
    if controller is None or isinstance(controller, str):
        controller = resolve_controller_json(controller, robot) or controller
    ctype = controller.get("type") if isinstance(controller, dict) else None
    body = controller if isinstance(controller, dict) and "body_parts" in controller else None
    specific = dict(controller.get("composite_controller_specific_configs", {})) if ctype else {}
    if ctype == "WHOLE_BODY_MINK_IK":
        ctype = "WHOLE_BODY_IK"
        if "ik_posture_weights" in specific:
            specific.setdefault("nullspace_joint_weights", specific["ik_posture_weights"])
    if ctype in THIRD_PARTY_COMPOSITE_CONTROLLERS:
        return CompositeResolution(ctype, body, _tracking_arms(dims),
                                   custom=(THIRD_PARTY_COMPOSITE_CONTROLLERS[ctype], specific))
    if ctype is not None and ctype not in REGISTERED_COMPOSITE_CONTROLLERS:
        raise ValueError(f"unknown composite controller {ctype!r}; known: {REGISTERED_COMPOSITE_CONTROLLERS} and "
                         f"the registered {sorted(THIRD_PARTY_COMPOSITE_CONTROLLERS)}")
    wbik = specific if ctype == "WHOLE_BODY_IK" else None
    if wbik is not None and body is None:
        return CompositeResolution(ctype, None, _tracking_arms(dims), wbik=wbik)
    if ctype is not None and body is None:
        raise ValueError(f"composite controller {ctype!r} needs body_parts")
    arm_cfg = load_composite_controller_config(body if body is not None else controller, robot, arms, dims)
    return CompositeResolution(ctype, body, arm_cfg, wbik=wbik)


def body_part_config(resolved: Optional[dict], part: str, dim: int, kp: float):
    """The torso / head / legs part's JOINT_POSITION config (the JAX
    robots/robot.py:642-659): the body_parts entry's kp, input_type and
    output range over the robot's kp, absolute input (legs: delta, so that
    a zero action holds the stance) and +-0.5."""
    entry = ((resolved or {}).get("body_parts") or {}).get(part)
    entry = entry if isinstance(entry, dict) else {}
    return jp_mod.JointPosConfig(dim=dim, kp=float(entry.get("kp", kp)),
                                 input_type=entry.get("input_type", "delta" if part == "legs" else "absolute"),
                                 output_max=float(entry.get("output_max", 0.5)),
                                 output_min=float(entry.get("output_min", -0.5)))
