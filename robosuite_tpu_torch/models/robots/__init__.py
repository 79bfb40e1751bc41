"""Robot models: spec factories + metadata for the built-in manipulators.

Copy of the JAX package's robot model layer: the fixed-mount Panda,
Sawyer, SpotArm, PandaDexRH / PandaDexLH (a Panda with an Inspire hand),
the bimanual Baxter, and the UR5e, Kinova3, IIWA, Jaco and XArm7, whose
grippers couple their fingers with tendons and equality constraints; the
wheeled PandaOmron and Tiago; the legged SpotWithArm and
SpotWithArmFloating; and the GR1 humanoid with its variants
GR1FixedLowerBody, GR1FloatingBody and GR1ArmsOnly, cut out of its spec
(robosuite models/robots/robot_model.py, manipulators/*.py,
compositional.py, legged_manipulator_model.py). Each robot is a thin
class over its committed model card plus robosuite's published metadata
(init_qpos, default gripper/base, placement offsets).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from robosuite_tpu_torch.models import spec as S
from robosuite_tpu_torch.models.cards import load_card, spec_from_card

REGISTERED_ROBOTS: Dict[str, type] = {}


def register_robot(cls):
    REGISTERED_ROBOTS[cls.__name__] = cls
    return cls


def create_robot(name: str, **kwargs):
    if name not in REGISTERED_ROBOTS:
        raise ValueError(f"unknown robot {name}; known: {sorted(REGISTERED_ROBOTS)}")
    return REGISTERED_ROBOTS[name](**kwargs)


class ManipulatorModel:
    """A fixed-base manipulator spec factory (robosuite
    manipulator_model.py): card subtree + mount + grippers with the
    prefixing scheme robot{idn}_ / gripper{idn}_{arm}_ / fixed_mount{idn}_."""

    card_name: str = None
    arms: List[str] = ["right"]

    def __init__(self, idn=0):
        self.idn = idn
        self.card = load_card(self.card_name)
        self.grippers: Dict[str, "object"] = {}
        self.base = None
        self._root: Optional[S.BodySpec] = None
        self._actuators: List[S.ActuatorSpec] = []
        self._equalities: List[S.EqualitySpec] = []
        self._tendons: List[S.TendonSpec] = []
        self._build()

    # -- metadata (overridden per robot) -------------------------------------
    @property
    def naming_prefix(self):
        return f"robot{self.idn}_"

    @property
    def default_base(self):
        return "RethinkMount"

    @property
    def default_gripper(self) -> Dict[str, str]:
        raise NotImplementedError

    @property
    def init_qpos(self) -> np.ndarray:
        raise NotImplementedError

    @property
    def base_xpos_offset(self) -> dict:
        return {
            "bins": (-0.5, -0.1, 0),
            "empty": (-0.6, 0, 0),
            "table": lambda table_length: (-0.16 - table_length / 2, 0, 0),
        }

    @property
    def top_offset(self):
        return np.array((0, 0, 1.0))

    @property
    def horizontal_radius(self):
        return 0.5

    @property
    def arm_type(self):
        """"single", or "bimanual" (two arms, right and left, in one robot)."""
        return "single"

    # the runtime class: "fixed" FixedBaseRobot, "wheeled" MobileRobot,
    # "legged" LeggedRobot (robosuite robots/__init__.py:15-34)
    robot_kind = "fixed"

    @property
    def card_joint_names(self) -> List[str]:
        """All prefixed robot-card joints in card order but those the spec
        surgery removed (robosuite robot.py _ref_joint_indexes); init_qpos
        covers exactly these."""
        out = []
        removed = getattr(self, "_removed_joints", ())

        def walk(bd):
            for j in bd.get("joints", []):
                if j.get("type") != "free" and j["name"] not in removed:
                    out.append(j["name"])
            for c in bd.get("children", []):
                walk(c)

        for bd in self.card["bodies"]:
            walk(bd)
        return [self.naming_prefix + j for j in out]

    @property
    def _eef_name(self) -> Dict[str, str]:
        """The unprefixed eef body of each arm (robosuite
        manipulator_model.py:176)."""
        return {arm: f"{arm}_hand" for arm in self.arms}

    @property
    def eef_name(self) -> Dict[str, str]:
        return {arm: self.naming_prefix + n for arm, n in self._eef_name.items()}

    # -- the non-arm parts (robosuite manipulator_model.py:97-114 classifies
    # the card's joints by name; a mobile or legged base adds its own)
    @property
    def base_joints(self) -> List[str]:
        """The base's planar joints."""
        return self.base.base_joints if self.base is not None else []

    @property
    def torso_joints(self) -> List[str]:
        return [j for j in self.card_joint_names if "torso" in j] + (
            self.base.torso_joints if self.base is not None else [])

    @property
    def head_joints(self) -> List[str]:
        return [j for j in self.card_joint_names if "head" in j]

    @property
    def legs_joints(self) -> List[str]:
        return [j for j in self.card_joint_names if "leg" in j] + (
            self.base.leg_joints if self.base is not None else [])

    @property
    def init_torso_qpos(self):
        """The torso's reset posture (the last torso joints), or None."""
        return None

    @property
    def base_offset(self):
        return np.zeros(3)

    @property
    def bottom_offset(self):
        if self.base is not None:
            return (self.base.bottom_offset - self.base.top_offset) + self.base_offset
        return self.base_offset

    # -- spec surgery (robosuite legged_manipulator_model.py:22-63) -----------
    def _remove_joint_actuation(self, part_name: str):
        """Remove the joints whose name holds `part_name`, and their
        actuators: the links become rigid decorations. The removed joints
        are kept unprefixed, as the card names them."""
        removed = set()
        for b in self._root.walk():
            removed |= {j.name for j in b.joints if part_name in j.name}
            b.joints = [j for j in b.joints if part_name not in j.name]
        self._actuators = [a for a in self._actuators if part_name not in a.name and a.joint not in removed]
        pre = self.naming_prefix
        self._removed_joints = getattr(self, "_removed_joints", set()) | {
            n[len(pre):] if n.startswith(pre) else n for n in removed}

    def _remove_free_joint(self):
        for b in self._root.walk():
            b.joints = [j for j in b.joints if j.type != "free"]

    # -- construction ---------------------------------------------------------
    def _build(self):
        ms = spec_from_card(self.card_name)
        assert len(ms.worldbody.children) == 1, "robot card must have one root body"
        self._root = ms.worldbody.children[0]
        # robosuite robot_model.py:74-79: default joint attribs where the
        # model card leaves them unset (0.0)
        i = 0
        for b in self._root.walk():
            for j in b.joints:
                if j.frictionloss == 0.0:
                    j.frictionloss = 0.1
                if j.damping == 0.0:
                    j.damping = 0.1
                if j.armature == 0.0:
                    j.armature = 5.0 / (i + 1)
                i += 1
        self._root.apply_prefix(self.naming_prefix)
        self._actuators = [
            S.ActuatorSpec(
                name=self.naming_prefix + a.name, joint=self.naming_prefix + a.joint, kind=a.kind,
                gear=a.gear, ctrlrange=a.ctrlrange, forcerange=a.forcerange, kp=a.kp, kv=a.kv,
            )
            for a in ms.actuators
        ]

    def add_base(self, base):
        """A mount hangs under the robot root (robosuite robot_model.py:145-170;
        its root's pos is overwritten). A mobile or legged base carries the
        robot (robot_model.py:171-237): the robot root keeps its name and
        holds the base's subtree, and the root's own content moves into a
        '<prefix>manipulator_mount' body on the base's '<base prefix>support'
        body."""
        assert self.base is None, "base already added"
        sub = base.root_subtree()
        sub.pos = self.base_offset - base.top_offset
        root = self._root
        if not base.mount:
            mount = S.BodySpec(self.naming_prefix + "manipulator_mount")
            mount.joints = [j for j in root.joints if j.type != "free"]
            mount.geoms, mount.sites, mount.cameras, mount.children = root.geoms, root.sites, root.cameras, \
                root.children
            mount.inertial = None  # the base carries the inertia (robot_model.py:212-216)
            root.joints, root.geoms, root.sites, root.cameras, root.children = [], [], [], [], []
            support = sub.find_body(base.naming_prefix + "support")
            assert support is not None, f"{base.naming_prefix}support body not in the base's card"
            support.children.append(mount)
        root.children.append(sub)
        self._actuators.extend(base.actuators())
        self.base = base

    # a gripper root's pos / quat (wxyz) replaced at mounting, by arm
    # (robosuite robot.py:198-212); empty: the card's own
    @property
    def gripper_mount_pos_offset(self) -> dict:
        return {}

    @property
    def gripper_mount_quat_offset(self) -> dict:
        return {}

    def add_gripper(self, gripper, arm: str):
        eef_body = self._root.find_body(self.eef_name[arm])
        assert eef_body is not None, f"eef body {self.eef_name[arm]} not found"
        sub = gripper.root_subtree()
        if arm in self.gripper_mount_pos_offset:
            sub.pos = np.asarray(self.gripper_mount_pos_offset[arm], dtype=float)
        if arm in self.gripper_mount_quat_offset:
            sub.quat = np.asarray(self.gripper_mount_quat_offset[arm], dtype=float)
        eef_body.children.append(sub)
        self._actuators.extend(gripper.actuators())
        self._equalities.extend(gripper.equalities())
        self._tendons.extend(gripper.tendons())
        self.grippers[arm] = gripper

    def set_base_xpos(self, xpos):
        """robosuite robot_model.py:89-99."""
        self._root.pos = np.asarray(xpos) - self.bottom_offset

    def set_base_ori(self, rot_euler):
        """The root's orientation from xyz euler angles, q = qz qy qx
        (robosuite robot_model.py:101-107)."""
        ax, ay, az = rot_euler

        def q_axis(angle, axis):
            v = [0.0, 0.0, 0.0]
            v[axis] = math.sin(angle / 2.0)
            return np.array([math.cos(angle / 2.0), *v])

        def qmul(a, b):
            w0, x0, y0, z0 = a
            w1, x1, y1, z1 = b
            return np.array([w0 * w1 - x0 * x1 - y0 * y1 - z0 * z1, w0 * x1 + x0 * w1 + y0 * z1 - z0 * y1,
                             w0 * y1 - x0 * z1 + y0 * w1 + z0 * x1, w0 * z1 + x0 * y1 - y0 * x1 + z0 * w1])

        self._root.quat = qmul(qmul(q_axis(az, 2), q_axis(ay, 1)), q_axis(ax, 0))

    # -- exports --------------------------------------------------------------
    def root_subtree(self) -> S.BodySpec:
        return self._root

    def actuators(self) -> List[S.ActuatorSpec]:
        return list(self._actuators)

    def equalities(self) -> List[S.EqualitySpec]:
        return list(self._equalities)

    def tendons(self) -> List[S.TendonSpec]:
        return list(self._tendons)

    @property
    def arm_joint_names(self) -> Dict[str, List[str]]:
        """Prefixed arm joint names by arm, card order: the card's joints
        but torso, mobile, head and leg ones (robosuite
        manipulator_model.py:97-114); a bimanual robot's split in half,
        right first (fixed_base_robot.py:91-93)."""
        pre = len(self.naming_prefix)
        flat = [j for j in self.card_joint_names
                if not any(tag in j[pre:] for tag in ("torso", "mobile", "head", "leg"))]
        if self.arm_type == "single":
            return {"right": flat}
        half = len(flat) // 2
        return {"right": flat[:half], "left": flat[half:]}

    @property
    def arm_actuator_names(self) -> Dict[str, List[str]]:
        return {
            arm: [a.name for a in self._actuators if a.joint in jnames]
            for arm, jnames in self.arm_joint_names.items()
        }

    def center_site_name(self, arm: str) -> str:
        """The base-frame reference site for part controllers
        (robosuite osc.py:457 f"{prefix}{part}_center")."""
        return f"{self.naming_prefix}{arm}_center"


@register_robot
class Panda(ManipulatorModel):
    """robosuite models/robots/manipulators/panda_robot.py:7-57 (+ its joint
    damping override (0.1 x4, 0.01 x3))."""

    card_name = "panda"
    arms = ["right"]

    def _build(self):
        super()._build()
        damping = [0.1, 0.1, 0.1, 0.1, 0.1, 0.01, 0.01]
        i = 0
        for b in self._root.walk():
            for j in b.joints:
                if i < 7:
                    j.damping = damping[i]
                    i += 1

    @property
    def default_gripper(self):
        return {"right": "PandaGripper"}

    @property
    def init_qpos(self):
        return np.array([0, np.pi / 16.0, 0.00, -np.pi / 2.0 - np.pi / 3.0, 0.00, np.pi - 0.2, np.pi / 4])


@register_robot
class Sawyer(ManipulatorModel):
    """robosuite models/robots/manipulators/sawyer_robot.py."""

    card_name = "sawyer"
    arms = ["right"]

    @property
    def default_gripper(self):
        return {"right": "RethinkGripper"}

    @property
    def init_qpos(self):
        return np.array([0, -1.18, 0.00, 2.18, 0.00, 0.57, -1.57])


@register_robot
class SpotArm(ManipulatorModel):
    """robosuite manipulators/spot_arm.py: the Spot arm (6 joints) on a
    RethinkMount, with its joint damping override (0.1 x5, 0.01)."""

    card_name = "spot_arm"

    def _build(self):
        super()._build()
        damping = [0.1, 0.1, 0.1, 0.1, 0.1, 0.01]
        i = 0
        for b in self._root.walk():
            for j in b.joints:
                if i < len(damping):
                    j.damping = damping[i]
                    i += 1

    @property
    def default_gripper(self):
        return {"right": "BDGripper"}

    @property
    def init_qpos(self):
        return np.array([0.0, -1.2, 1.85, 0.0, 0.862, 0.0])

    @property
    def base_xpos_offset(self):
        return {
            "bins": (-0.5, -0.1, 0),
            "empty": (-0.6, 0, 0),
            "table": lambda table_length: (-0.16 - 0.9 - table_length / 2, 0.0, 0.0),
        }


@register_robot
class PandaDexRH(Panda):
    """robosuite compositional.py:79-90: a Panda with an Inspire right hand,
    mounted at the wrist turned by the quat (-0.5, 0.5, 0.5, -0.5)."""

    @property
    def default_gripper(self):
        return {"right": "InspireRightHand"}

    @property
    def gripper_mount_pos_offset(self):
        return {"right": [0.0, 0.0, 0.0]}

    @property
    def gripper_mount_quat_offset(self):
        return {"right": [-0.5, 0.5, 0.5, -0.5]}


@register_robot
class PandaDexLH(Panda):
    """robosuite compositional.py:93-104: a Panda with an Inspire left hand."""

    @property
    def default_gripper(self):
        return {"right": "InspireLeftHand"}

    @property
    def gripper_mount_pos_offset(self):
        return {"right": [0.0, 0.0, 0.0]}

    @property
    def gripper_mount_quat_offset(self):
        return {"right": [0.5, -0.5, 0.5, -0.5]}


@register_robot
class Baxter(ManipulatorModel):
    """robosuite manipulators/baxter_robot.py: two 7-joint arms (right, then
    left) in one robot on a RethinkMinimalMount, a Rethink gripper on each."""

    card_name = "baxter"
    arms = ["right", "left"]

    @property
    def arm_type(self):
        return "bimanual"

    @property
    def default_base(self):
        return "RethinkMinimalMount"

    @property
    def default_gripper(self):
        return {"right": "RethinkGripper", "left": "RethinkGripper"}

    @property
    def init_qpos(self):
        return np.array(
            [0.403, -0.636, 0.114, 1.432, 0.735, 1.205, -0.269, -0.403, -0.636, -0.114, 1.432, -0.735, 1.205, 0.269])

    @property
    def base_xpos_offset(self):
        return {
            "bins": (-0.5, -0.1, 0),
            "empty": (-0.29, 0, 0),
            "table": lambda table_length: (-0.26 - table_length / 2, 0, 0),
        }


@register_robot
class UR5e(ManipulatorModel):
    """robosuite manipulators/ur5e_robot.py: 6 joints, a Robotiq 85."""

    card_name = "ur5e"

    @property
    def default_gripper(self):
        return {"right": "Robotiq85Gripper"}

    @property
    def init_qpos(self):
        return np.array([-0.470, -1.735, 2.480, -2.275, -1.590, -1.991])


@register_robot
class Kinova3(ManipulatorModel):
    """robosuite manipulators/kinova3_robot.py: 7 joints, a Robotiq 85."""

    card_name = "kinova3"

    @property
    def default_gripper(self):
        return {"right": "Robotiq85Gripper"}

    @property
    def init_qpos(self):
        return np.array([0.000, 0.650, 0.000, 1.890, 0.000, 0.600, -np.pi / 2])


@register_robot
class IIWA(ManipulatorModel):
    """robosuite manipulators/iiwa_robot.py: 7 joints, a Robotiq 140."""

    card_name = "iiwa"

    @property
    def default_gripper(self):
        return {"right": "Robotiq140Gripper"}

    @property
    def init_qpos(self):
        return np.array([0.000, 0.650, 0.000, -1.890, 0.000, 0.600, 0.000])


@register_robot
class Jaco(ManipulatorModel):
    """robosuite manipulators/jaco_robot.py: 7 joints, the Jaco
    three-finger gripper."""

    card_name = "jaco"

    @property
    def default_gripper(self):
        return {"right": "JacoThreeFingerGripper"}

    @property
    def init_qpos(self):
        return np.array([3.192, 3.680, -0.000, 1.170, 0.050, 3.760, 3.142])


@register_robot
class XArm7(ManipulatorModel):
    """robosuite manipulators/xarm7_robot.py: 7 joints, the XArm7 gripper."""

    card_name = "xarm7"

    @property
    def default_gripper(self):
        return {"right": "XArm7Gripper"}

    @property
    def init_qpos(self):
        return np.array([0.0, 0.0, 0.0, 0.39 * np.pi, 0.0, 0.39 * np.pi, 0.0])


@register_robot
class PandaOmron(Panda):
    """robosuite compositional.py:6-28: a Panda on an OmronMobileBase, under
    the HYBRID_MOBILE_BASE composite (default_pandaomron.json)."""

    robot_kind = "wheeled"
    composite_type = "HYBRID_MOBILE_BASE"
    part_controller_kp = {"torso": 2000.0, "head": 1000.0}

    @property
    def default_base(self):
        return "OmronMobileBase"

    @property
    def init_qpos(self):
        return np.array([0, np.pi / 16.0 - 0.2, 0.00, -np.pi / 2.0 - np.pi / 3.0, 0.00, np.pi - 0.4, np.pi / 4])

    @property
    def init_torso_qpos(self):
        return np.array([0.2])

    @property
    def base_xpos_offset(self):
        return {
            "bins": (-0.6, -0.1, 0),
            "empty": (-0.6, 0, 0),
            "table": lambda table_length: (-0.16 - table_length / 2, 0, 0),
        }


@register_robot
class SpotWithArm(SpotArm):
    """robosuite compositional.py:31-52: the Spot arm on the legged Spot body
    (a free root joint, 12 actuated legs)."""

    robot_kind = "legged"

    @property
    def default_base(self):
        return "Spot"

    @property
    def init_qpos(self):
        return np.array([0.0, -2, 1.26, -0.335, 0.862, 0.0])

    @property
    def base_xpos_offset(self):
        return {
            "bins": (-1.05, -0.1, -0.22),
            "empty": (-1.1, 0, -0.22),
            "table": lambda table_length: (-0.5 - table_length / 2, 0.0, -0.22),
        }


@register_robot
class SpotWithArmFloating(SpotArm):
    """robosuite compositional.py:53-74: the Spot arm on the de-legged Spot
    body with planar joints."""

    robot_kind = "legged"

    @property
    def default_base(self):
        return "SpotFloating"

    @property
    def init_qpos(self):
        return np.array([0.0, -2, 1.26, -0.335, 0.862, 0.0])

    @property
    def base_xpos_offset(self):
        return {
            "bins": (-0.7, -0.1, 0.0),
            "empty": (-0.6, 0, 0.0),
            "table": lambda table_length: (-0.5 - table_length / 2, 0.0, 0.0),
        }


def _gr1_arms_qpos(n, start):
    """A GR1 variant's init_qpos: n zeros with the arms' reset posture from
    `start` (right arm 7, then left arm 7)."""
    q = np.zeros(n)
    q[start:start + 7] = [0.0, -0.1, 0.0, -1.57, 0.0, 0.0, 0.0]
    q[start + 7:start + 14] = [0.0, 0.1, 0.0, -1.57, 0.0, 0.0, 0.0]
    return q


@register_robot
class GR1(ManipulatorModel):
    """robosuite gr1_robot.py:7-101: the Fourier GR1 humanoid, bimanual: a
    3-joint torso, a 3-joint head, two 7-joint arms and 12 actuated leg
    joints under the NoActuationBase (which takes the card's free root
    joint away), a Fourier hand on each arm."""

    card_name = "gr1"
    arms = ["right", "left"]
    robot_kind = "legged"

    @property
    def arm_type(self):
        return "bimanual"

    @property
    def _eef_name(self):
        return {"right": "right_eef", "left": "left_eef"}

    @property
    def default_base(self):
        return "NoActuationBase"

    @property
    def default_gripper(self):
        return {"right": "FourierRightHand", "left": "FourierLeftHand"}

    @property
    def init_qpos(self):
        # card order: torso 3, head 3, right arm 7, left arm 7, legs 12
        return _gr1_arms_qpos(32, 6)

    @property
    def base_xpos_offset(self):
        return {
            "bins": (-0.30, -0.1, 0.95),
            "empty": (-0.29, 0, 0.95),
            "table": lambda table_length: (-0.15 - table_length / 2, 0, 0.95),
        }


@register_robot
class GR1FixedLowerBody(GR1):
    """robosuite gr1_robot.py:104-130: the legs' joints removed, and the
    free joint."""

    def __init__(self, idn=0):
        super().__init__(idn=idn)
        self._remove_joint_actuation("leg")
        self._remove_free_joint()

    @property
    def init_qpos(self):
        return _gr1_arms_qpos(20, 6)


@register_robot
class GR1FloatingBody(GR1FixedLowerBody):
    """robosuite gr1_robot.py:133-166: the legless GR1 on a
    FloatingLeggedBase (planar joints), under HYBRID_MOBILE_BASE."""

    composite_type = "HYBRID_MOBILE_BASE"

    @property
    def default_base(self):
        return "FloatingLeggedBase"

    @property
    def base_xpos_offset(self):
        return {
            "bins": (-0.30, -0.1, 0.97),
            "empty": (-0.29, 0, 0.97),
            "table": lambda table_length: (-0.15 - table_length / 2, 0, 0.97),
        }


@register_robot
class GR1ArmsOnly(GR1):
    """robosuite gr1_robot.py:169-195: the arms alone; the legs', head's
    and torso's joints removed, and the free joint."""

    def __init__(self, idn=0):
        super().__init__(idn=idn)
        for part in ("leg", "head", "torso"):
            self._remove_joint_actuation(part)
        self._remove_free_joint()

    @property
    def init_qpos(self):
        return _gr1_arms_qpos(14, 0)


@register_robot
class Tiago(ManipulatorModel):
    """robosuite tiago_robot.py: a bimanual wheeled manipulator; its card has
    the torso lift, 2 head joints and 2 x 6 arm joints, the planar joints
    come from the NullMobileBase, a Robotiq 85 on each arm."""

    card_name = "tiago"
    arms = ["right", "left"]
    robot_kind = "wheeled"

    @property
    def arm_type(self):
        return "bimanual"

    @property
    def default_base(self):
        return "NullMobileBase"

    @property
    def default_gripper(self):
        return {"right": "Robotiq85Gripper", "left": "Robotiq85Gripper"}

    @property
    def init_qpos(self):
        # card order: torso_lift, head_1, head_2, right arm x6, left arm x6
        return np.array([0.1, 0, 0, 0, -0.9, 1.45, 1.7, -1.5, 0.5, 0, -0.9, 1.45, 1.7, -1.5, 0.5])

    @property
    def base_xpos_offset(self):
        return {
            "bins": (-0.5, -0.1, 0),
            "empty": (-0.29, 0, 0),
            "table": lambda table_length: (-0.20 - table_length / 2, 0, 0),
        }
