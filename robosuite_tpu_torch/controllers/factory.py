"""Controller config resolution (the JAX package's controllers/factory.py;
robosuite controller_factory.py and composite_controller_factory.py),
for the BASIC composite with OSC_POSE or JOINT_POSITION arms.

Search order as in robosuite: an explicit dict, a composite name
(config/default/composite/<name>.json), the per-robot default
(config/robots/default_<robot>.json).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Union

from robosuite_tpu_torch.controllers.parts import joint_pos as jp_mod
from robosuite_tpu_torch.controllers.parts import osc as osc_mod

_CFG_ROOT = os.path.join(os.path.dirname(__file__), "config")


def arm_controller_config(ctrl_type: str, dim: int = 7, **overrides):
    """A part-controller config dataclass (robosuite controller_factory.py
    arm_controller_factory); OSC_POSE and JOINT_POSITION are ported. Keys
    the dataclass has no field for (kd/velocity_limits of the reference
    JSON) are dropped."""
    t = ctrl_type.upper()
    if t == "OSC_POSE":  # the JAX factory's OSC defaults: its damping-ratio limits are (0, 10)
        cls, kw = osc_mod.OSCConfig, dict(damping_ratio_limits=(0.0, 10.0))
    elif t == "JOINT_POSITION":
        cls, kw = jp_mod.JointPosConfig, dict(dim=dim, input_max=1.0, input_min=-1.0, output_max=0.05,
                                              output_min=-0.05, kp=50.0)
    else:
        raise NotImplementedError(f"controller type {ctrl_type!r} is not ported (OSC_POSE, JOINT_POSITION)")
    fields = {f.name for f in dataclasses.fields(cls)}
    kw.update({k: tuple(v) if isinstance(v, list) else v for k, v in overrides.items() if k in fields})
    return cls(**kw)


def resolve_controller_json(controller: Union[None, str, dict], robot: Optional[str]) -> Optional[dict]:
    if isinstance(controller, dict):
        return controller
    if isinstance(controller, str):
        path = controller if controller.endswith(".json") else os.path.join(
            _CFG_ROOT, "default", "composite", controller.lower() + ".json")
    else:
        path = os.path.join(_CFG_ROOT, "robots", f"default_{robot.lower()}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def load_composite_controller_config(controller=None, robot: Optional[str] = None, arms=("right",)):
    """Resolve to {arm: OSCConfig or JointPosConfig}. `controller` may also
    be a dict of part configs by arm, {"right": {"type": "OSC_POSE",
    "impedance_mode": "variable_kp"}} (the JAX factory's form), which is
    not modified."""
    if isinstance(controller, dict) and "body_parts" not in controller and "type" not in controller:
        out = {}
        for arm, cfg in controller.items():
            cfg = dict(cfg)
            out[arm] = arm_controller_config(cfg.pop("type"), **cfg)
        return out
    resolved = resolve_controller_json(controller, robot)
    if resolved is None:
        if isinstance(controller, str):
            return {arm: arm_controller_config(controller) for arm in arms}
        return {arm: arm_controller_config("OSC_POSE") for arm in arms}
    if resolved.get("type", "BASIC") != "BASIC":
        raise NotImplementedError(f"composite controller {resolved.get('type')!r} is not ported")
    out = {}
    for arm in arms:
        cfg = dict(resolved["body_parts"]["arms"][arm])
        out[arm] = arm_controller_config(cfg.pop("type"), **cfg)
    return out
