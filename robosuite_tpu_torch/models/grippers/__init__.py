"""Gripper models (robosuite models/grippers/*.py + gripper_factory.py):
the Panda, Rethink, Boston Dynamics, Robotiq (85, 140, three-finger),
Jaco three-finger, XArm7 and suction grippers, the Inspire and Fourier
hands, the null gripper and the wiping gripper. The Robotiq, Jaco and
XArm7 grippers couple their fingers through fixed tendons and equality
constraints, which the robot model merges into the world with the
gripper's actuators.

Each gripper wraps its model card with robosuite's metadata: dof, speed,
init_qpos, important sites (grip_site for the OSC reference frame) and
fingerpad geoms (grasp checks). The open/close ramp state
(robosuite panda_gripper.py:42-55) lives in the robot layer's explicit
gripper state, not here.
"""

from __future__ import annotations

from typing import Dict, List

import dataclasses

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
        pre = lambda name: p + name if name else None  # noqa: E731
        self._actuators = [
            S.ActuatorSpec(
                name=p + a.name, joint=pre(a.joint), kind=a.kind, gear=a.gear, ctrlrange=a.ctrlrange,
                forcerange=a.forcerange, kp=a.kp, kv=a.kv, tendon=pre(a.tendon), gainprm=a.gainprm,
                biasprm=a.biasprm,
            )
            for a in ms.actuators
        ]
        self._equalities = [
            dataclasses.replace(e, body1=pre(e.body1), body2=pre(e.body2), joint1=pre(e.joint1),
                                joint2=pre(e.joint2), tendon1=pre(e.tendon1), tendon2=pre(e.tendon2))
            for e in ms.equalities
        ]
        self._tendons = [dataclasses.replace(t, name=p + t.name, joints=[p + j for j in t.joints])
                         for t in ms.tendons]

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

    def equalities(self):
        return list(self._equalities)

    def tendons(self):
        return list(self._tendons)

    def format_action_direction(self):
        """Per-actuator sign applied to the ramped open/close command."""
        return np.ones(len(self._actuators))

    def format_action_indices(self):
        """For a dexterous hand, each actuator's index into the dof-wide
        action, which drives the actuators directly (robosuite
        inspire_hands.py:22-28 `action[indices]`); None for a binary gripper,
        whose one action ramps every actuator."""
        return None

    # A dexterous ramped gripper (robosuite jaco_three_finger_gripper.py:82-108,
    # robotiq_three_finger_gripper.py:88-114) ramps each actuator from its
    # own action element, not all of them from the first.
    ramp_elementwise = False

    def format_action_fixed(self):
        """Each actuator's pinned command, NaN where free (the one-dof
        Robotiq three-finger gripper pins its scissor to -1,
        robotiq_three_finger_gripper.py:78); None: nothing pinned."""
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
    """A dexterous hand's finger geoms (robosuite inspire_hands.py:127-160,
    fourier_hands.py:49-81): the thumb's stand for the left finger and pad,
    the four fingers' for the right. An Inspire hand's prefix is "l" / "r",
    a Fourier hand's "L" / "R"."""
    if prefix in ("l", "r"):
        thumb = [f"{prefix}_thumb_proximal_col", f"{prefix}_thumb_proximal_2_col",
                 f"{prefix}_thumb_middle_col", f"{prefix}_thumb_distal_col"]
        fingers = [f"{prefix}_{f}_{seg}_col" for f in ("index", "middle", "ring", "pinky")
                   for seg in ("proximal", "distal")]
    else:
        thumb = [f"{prefix}_thumb_proximal_base_link_col", f"{prefix}_thumb_proximal_link_col",
                 f"{prefix}_thumb_distal_link_col"]
        fingers = [f"{prefix}_{f}_{seg}_link_col" for f in ("index", "middle", "ring", "pinky")
                   for seg in ("proximal", "intermediate")]
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


@register_gripper
class FourierLeftHand(GripperModel):
    """robosuite fourier_hands.py:10-82: a 6-dof dexterous hand whose 6-wide
    action drives its 11 position actuators directly, with no ramp (the
    thumb's two pitch joints share one action element)."""

    card_name = "fourier_left_hand"
    dof = 6
    speed = 0.15

    def __init__(self, idn=0, arm="left"):
        super().__init__(idn=idn, arm=arm)

    def format_action_indices(self):
        # actuators: pinky, ring, middle, index (intermediate, proximal
        # each), then the thumb's distal, proximal pitch, proximal yaw
        return np.array([0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5])

    @property
    def init_qpos(self):
        return np.zeros(11)

    @property
    def _important_geoms(self):
        return _hand_geoms("L")


@register_gripper
class FourierRightHand(FourierLeftHand):
    card_name = "fourier_right_hand"

    def __init__(self, idn=0, arm="right"):
        super().__init__(idn=idn, arm=arm)

    @property
    def _important_geoms(self):
        return _hand_geoms("R")


def _robotiq_geoms():
    return {
        "left_finger": ["left_outer_finger_collision", "left_inner_finger_collision", "left_fingertip_collision",
                        "left_fingerpad_collision"],
        "right_finger": ["right_outer_finger_collision", "right_inner_finger_collision", "right_fingertip_collision",
                         "right_fingerpad_collision"],
        "left_fingerpad": ["left_fingerpad_collision"],
        "right_fingerpad": ["right_fingerpad_collision"],
    }


@register_gripper
class Robotiq85Gripper(GripperModel):
    """robosuite robotiq_85_gripper.py: two position servos, each finger's
    three links coupled by a limited spring tendon (UR5e's, Kinova3's)."""

    card_name = "robotiq_gripper_85"
    dof = 1
    speed = 0.01

    @property
    def init_qpos(self):
        return np.array([-0.026, -0.267, -0.200, -0.026, -0.267, -0.200])

    @property
    def _important_geoms(self):
        return _robotiq_geoms()


@register_gripper
class Robotiq140Gripper(GripperModel):
    """robosuite robotiq_140_gripper.py: two position servos, the finger
    links pinned together by four tendon equalities (IIWA's)."""

    card_name = "robotiq_gripper_140"
    dof = 1
    speed = 0.2

    @property
    def init_qpos(self):
        return np.array([0.012, 0.065, 0.065, -0.012, 0.065, 0.065])

    @property
    def _important_geoms(self):
        return _robotiq_geoms()


@register_gripper
class JacoThreeFingerGripper(GripperModel):
    """robosuite jaco_three_finger_gripper.py: three position servos, each
    finger's distal joint pinned to its proximal one by a tendon equality
    (Jaco's)."""

    card_name = "jaco_three_finger_gripper"
    dof = 1
    speed = 0.01

    @property
    def init_qpos(self):
        return np.array([0.5, 0, 0.5, 0, 0.5, 0])

    @property
    def _important_geoms(self):
        return {
            "left_finger": ["index_proximal_collision", "index_distal_collision", "index_tip_collision",
                            "pinky_proximal_collision", "pinky_distal_collision", "pinky_tip_collision",
                            "index_pad_collision", "pinky_pad_collision"],
            "right_finger": ["thumb_proximal_collision", "thumb_distal_collision", "thumb_tip_collision",
                             "thumb_pad_collision"],
            "left_fingerpad": ["index_pad_collision", "pinky_pad_collision"],
            "right_fingerpad": ["thumb_pad_collision"],
        }


@register_gripper
class JacoThreeFingerDexterousGripper(JacoThreeFingerGripper):
    """robosuite jaco_three_finger_gripper.py:82-108: each finger ramped
    from its own action element (dof 3)."""

    dof = 3
    ramp_elementwise = True


@register_gripper
class XArm7Gripper(GripperModel):
    """robosuite xarm7_gripper.py: ONE `general` servo (affine bias) on the
    "split" fixed tendon (half each of the two finger-driving joints) moves
    both fingers, connect equalities close the four-bar fingers and a
    joint equality couples the two driving joints (xarm7_gripper.xml). +1 closes (ctrl
    ramps over 0..255)."""

    card_name = "xarm7_gripper"
    dof = 1
    speed = 0.2

    @property
    def init_qpos(self):
        return np.array([0.02, 0.0, 0.0, -0.02, 0.0, 0.0])

    @property
    def _important_geoms(self):
        return {
            "left_finger": ["finger1_collision", "finger1_pad_collision"],
            "right_finger": ["finger2_collision", "finger2_pad_collision"],
            "left_fingerpad": ["finger1_pad_collision"],
            "right_fingerpad": ["finger2_pad_collision"],
        }


@register_gripper
class RobotiqThreeFingerGripper(GripperModel):
    """robosuite robotiq_three_finger_gripper.py (S-model): one ramped
    action over the three finger actuators, the scissor pinned closed
    (robotiq_three_finger_gripper.py:64-84)."""

    card_name = "robotiq_three_finger_gripper"
    dof = 1
    speed = 0.01

    def format_action_fixed(self):
        # actuators finger_1, finger_2, middle_finger, finger_scissor
        return np.array([np.nan, np.nan, np.nan, -1.0])


@register_gripper
class RobotiqThreeFingerDexterousGripper(RobotiqThreeFingerGripper):
    """robosuite robotiq_three_finger_gripper.py:88-114: the three fingers
    and the scissor each ramped from its own action element (dof 4)."""

    dof = 4
    ramp_elementwise = True

    def format_action_fixed(self):
        return None


@register_gripper
class SuctionGripper(GripperModel):
    """A suction cup: its geometry and mounting, no actuator (dof 0;
    adhesion is not modelled, as in the JAX package)."""

    card_name = "suction_gripper"
    dof = 0
    speed = 0.0

    @property
    def _important_sites(self):
        return {"grip_site": "grip_site", "grip_cylinder": "grip_site_cylinder", "ee": "ft_frame"}
