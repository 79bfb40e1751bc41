"""Gripper models (robosuite models/grippers/*.py + gripper_factory.py),
trimmed to the Panda, Rethink and Boston Dynamics grippers, the Inspire
hands, the null gripper and the wiping gripper.

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

    def format_action_indices(self):
        """For a dexterous hand, each actuator's index into the dof-wide
        action, which drives the actuators directly (robosuite
        inspire_hands.py:22-28 `action[indices]`); None for a binary gripper,
        whose one action ramps every actuator."""
        return None


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


@register_gripper
class BDGripper(GripperModel):
    """robosuite bd_gripper.py (Boston Dynamics, SpotArm's): dof=1,
    speed=0.2, ramped binary action."""

    card_name = "bd_gripper"
    dof = 1
    speed = 0.2

    @property
    def init_qpos(self):
        return np.array([-1.57])

    @property
    def _important_geoms(self):
        # robosuite bd_gripper.py:31-36
        return {
            "left_finger": ["left_hinge_coll", "left_finger_coll", "left_tooth_coll"],
            "right_finger": ["right_hinge_coll", "right_finger_coll", "right_tooth_coll"],
            "left_fingerpad": ["left_finger_coll"],
            "right_fingerpad": ["right_finger_coll"],
        }


def _hand_geoms(prefix):
    """An Inspire hand's finger geoms (robosuite inspire_hands.py:127-160):
    the thumb's stand for the left finger and pad, the four fingers' for
    the right."""
    thumb = [f"{prefix}_thumb_proximal_col", f"{prefix}_thumb_proximal_2_col",
             f"{prefix}_thumb_middle_col", f"{prefix}_thumb_distal_col"]
    fingers = [f"{prefix}_{f}_{seg}_col" for f in ("index", "middle", "ring", "pinky")
               for seg in ("proximal", "distal")]
    return {"left_finger": thumb, "right_finger": fingers, "left_fingerpad": thumb, "right_fingerpad": fingers}


@register_gripper
class InspireLeftHand(GripperModel):
    """robosuite inspire_hands.py:10-85: a 6-dof dexterous hand whose 6-wide
    action drives its 12 position actuators directly, with no ramp."""

    card_name = "inspire_left_hand"
    dof = 6
    speed = 0.15

    def __init__(self, idn=0, arm="left"):
        super().__init__(idn=idn, arm=arm)

    def format_action_indices(self):
        # actuators: pinky, ring, middle, index (distal, proximal each),
        # then the thumb's distal, middle, proximal_2, proximal_1
        return np.array([0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 4, 5])

    @property
    def init_qpos(self):
        return np.zeros(12)

    @property
    def _important_geoms(self):
        return _hand_geoms("l")


@register_gripper
class InspireRightHand(InspireLeftHand):
    card_name = "inspire_right_hand"

    def __init__(self, idn=0, arm="right"):
        super().__init__(idn=idn, arm=arm)

    @property
    def _important_geoms(self):
        return _hand_geoms("r")
