"""Gripper models (robosuite models/grippers/*.py + gripper_factory.py),
trimmed to the Panda and Rethink grippers, the null gripper and the
wiping gripper.

Each gripper wraps its model card with robosuite's metadata: dof, speed,
init_qpos, important sites (grip_site for the OSC reference frame) and
fingerpad geoms (grasp checks). The open/close ramp state
(robosuite panda_gripper.py:42-55) lives in the robot layer's explicit
gripper state, not here.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from robosuite_tpu_torch.models import spec as S
from robosuite_tpu_torch.models.cards import spec_from_card

REGISTERED_GRIPPERS: Dict[str, type] = {}


def register_gripper(cls):
    REGISTERED_GRIPPERS[cls.__name__] = cls
    return cls


def gripper_factory(name: str, idn=0, arm="right"):
    """robosuite gripper_factory.py."""
    if name not in REGISTERED_GRIPPERS:
        raise ValueError(f"unknown gripper {name}; known: {sorted(REGISTERED_GRIPPERS)}")
    return REGISTERED_GRIPPERS[name](idn=idn, arm=arm)


class GripperModel:
    card_name: str = None
    dof: int = 1
    speed: float = 0.2

    def __init__(self, idn=0, arm="right"):
        self.idn = idn
        self.arm = arm
        ms = spec_from_card(self.card_name)
        assert len(ms.worldbody.children) == 1
        self._root = ms.worldbody.children[0]
        self._root.apply_prefix(self.naming_prefix)
        p = self.naming_prefix
        self._actuators = [
            S.ActuatorSpec(
                name=p + a.name, joint=p + a.joint, kind=a.kind,
                gear=a.gear, ctrlrange=a.ctrlrange, forcerange=a.forcerange, kp=a.kp, kv=a.kv,
            )
            for a in ms.actuators
        ]

    @property
    def naming_prefix(self):
        return f"gripper{self.idn}_{self.arm}_"

    @property
    def init_qpos(self):
        return np.zeros(0)

    @property
    def _important_sites(self):
        return {"grip_site": "grip_site", "grip_cylinder": "grip_site_cylinder", "ee": "ft_frame",
                "ee_x": "ee_x", "ee_y": "ee_y", "ee_z": "ee_z"}

    @property
    def important_sites(self):
        return {k: self.naming_prefix + v for k, v in self._important_sites.items()}

    @property
    def _important_geoms(self) -> Dict[str, List[str]]:
        return {}

    @property
    def important_geoms(self):
        return {k: [self.naming_prefix + g for g in v] for k, v in self._important_geoms.items()}

    @property
    def joint_names(self) -> List[str]:
        return [j.name for b in self._root.walk() for j in b.joints]

    @property
    def actuator_names(self) -> List[str]:
        return [a.name for a in self._actuators]

    def root_subtree(self):
        return self._root

    def actuators(self):
        return list(self._actuators)

    def format_action_direction(self):
        """Per-actuator sign applied to the ramped open/close command."""
        return np.ones(len(self._actuators))


@register_gripper
class PandaGripper(GripperModel):
    """robosuite panda_gripper.py: dof=1, speed=0.2, ramped binary action."""

    card_name = "panda_gripper"
    dof = 1
    speed = 0.2

    @property
    def init_qpos(self):
        return np.array([0.020833, -0.020833])

    @property
    def _important_geoms(self):
        return {
            "left_finger": ["finger1_collision", "finger1_pad_collision"],
            "right_finger": ["finger2_collision", "finger2_pad_collision"],
            "left_fingerpad": ["finger1_pad_collision"],
            "right_fingerpad": ["finger2_pad_collision"],
        }

    def format_action_direction(self):
        return np.array([-1.0, 1.0])


@register_gripper
class RethinkGripper(GripperModel):
    """robosuite rethink_gripper.py: dof=1, speed=0.2, ramped binary action."""

    card_name = "rethink_gripper"
    dof = 1
    speed = 0.2

    @property
    def init_qpos(self):
        return np.array([0.020833, -0.020833])

    @property
    def _important_geoms(self):
        return {
            "left_finger": ["l_finger_g0", "l_finger_g1", "l_fingertip_g0", "l_fingerpad_g0"],
            "right_finger": ["r_finger_g0", "r_finger_g1", "r_fingertip_g0", "r_fingerpad_g0"],
            "left_fingerpad": ["l_fingerpad_g0"],
            "right_fingerpad": ["r_fingerpad_g0"],
        }

    def format_action_direction(self):
        return np.array([1.0, -1.0])


@register_gripper
class NullGripper(GripperModel):
    """robosuite null_gripper.py: no fingers and no actuators (dof 0); the
    eef sites only (TwoArmPegInHole welds its peg and plate at the eef)."""

    card_name = "null_gripper"
    dof = 0
    speed = 0.0

    @property
    def _important_sites(self):
        return {"grip_site": "grip_site", "grip_cylinder": "grip_site_cylinder", "ee": "ft_frame"}


@register_gripper
class WipingGripper(GripperModel):
    """robosuite wiping_gripper.py (Wipe): a wiping plate, no fingers and no
    actuators (dof 0)."""

    card_name = "wiping_gripper"
    dof = 0
    speed = 0.0

    @property
    def _important_sites(self):
        return {"grip_site": "grip_site", "grip_cylinder": "grip_site_cylinder", "ee": "ft_frame"}
