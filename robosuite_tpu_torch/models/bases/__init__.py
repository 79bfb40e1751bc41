"""Robot bases (robosuite models/bases/*.py; the JAX package's
models/bases): the fixed mounts RethinkMount (Panda, Sawyer, SpotArm),
RethinkMinimalMount (Baxter) and NullMount (a bare body), and the mobile
and legged bases the robot rides on: OmronMobileBase (PandaOmron),
NullMobileBase (Tiago), FloatingLeggedBase, NoActuationBase, Spot (the
legged body on a free root joint, SpotWithArm) and SpotFloating (the
de-legged body on planar joints, SpotWithArmFloating)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from robosuite_tpu_torch.models import spec as S
from robosuite_tpu_torch.models.cards import spec_from_card

REGISTERED_BASES: Dict[str, type] = {}


def register_base(cls):
    REGISTERED_BASES[cls.__name__] = cls
    return cls


def robot_base_factory(name: str, idn=0):
    """robosuite bases/robot_base_factory.py (None: the NullMount)."""
    if name is None:
        name = "NullMount"
    if name not in REGISTERED_BASES:
        raise ValueError(f"unknown base {name}; known: {sorted(REGISTERED_BASES)}")
    return REGISTERED_BASES[name](idn=idn)


class RobotBaseModel:
    """A card subtree: hung under the robot root (a fixed mount), or the body
    the robot rides on (mount False: a mobile or legged base)."""

    card_name: str = None
    mount: bool = True

    def __init__(self, idn=0):
        self.idn = idn
        ms = spec_from_card(self.card_name)
        assert len(ms.worldbody.children) == 1
        self._root = ms.worldbody.children[0]
        self._customize_spec(ms)
        self._root.apply_prefix(self.naming_prefix)
        self._actuators: List[S.ActuatorSpec] = [
            S.ActuatorSpec(
                name=self.naming_prefix + a.name, joint=self.naming_prefix + a.joint, kind=a.kind,
                gear=a.gear, ctrlrange=a.ctrlrange, forcerange=a.forcerange, kp=a.kp, kv=a.kv,
            )
            for a in ms.actuators
        ]

    def _customize_spec(self, ms):
        """Edit the card's spec before prefixing (SpotFloating)."""

    @property
    def naming_prefix(self):
        # robosuite mount_model.py:10, mobile_base_model.py:10
        return f"fixed_mount{self.idn}_" if self.mount else f"mobilebase{self.idn}_"

    # -- mobile-base metadata (empty for mounts) ------------------------------
    def _own_joints(self, pred):
        """The base's own prefixed joints (after mounting, the robot's
        subtree hangs under this root) that satisfy pred(name)."""
        return [j.name for b in self._root.walk() for j in b.joints
                if j.name.startswith(self.naming_prefix) and pred(j)]

    @property
    def base_joints(self) -> List[str]:
        """The planar joints the base controller drives (robosuite
        mobile_robot.py:81)."""
        if self.mount:
            return []
        found = set(self._own_joints(lambda j: True))
        want = ("joint_mobile_forward", "joint_mobile_side", "joint_mobile_yaw")
        return [self.naming_prefix + w for w in want if self.naming_prefix + w in found]

    @property
    def torso_joints(self) -> List[str]:
        return [] if self.mount else self._own_joints(lambda j: "torso" in j.name)

    @property
    def leg_joints(self) -> List[str]:
        """The actuated leg joints of a legged base."""
        return []

    @property
    def center_site(self) -> str:
        """The site the mobile-base controller reads the base's yaw from
        (robosuite mobile_base_controller.py:89-94)."""
        return self.naming_prefix + "center"

    @property
    def init_qpos(self):
        return np.array([])

    @property
    def top_offset(self):
        return np.array((0.0, 0.0, 0.0))

    @property
    def bottom_offset(self):
        return np.array((0.0, 0.0, 0.0))

    @property
    def horizontal_radius(self):
        return 0.0

    def root_subtree(self):
        return self._root

    def actuators(self):
        return list(self._actuators)


@register_base
class RethinkMount(RobotBaseModel):
    """robosuite bases/rethink_mount.py: top_offset (0,0,-0.01); the card's
    root body sits at z=-0.922 so bottom_offset = (0,0,-0.922)."""

    card_name = "rethink_mount"

    @property
    def top_offset(self):
        return np.array((0.0, 0.0, -0.01))

    @property
    def bottom_offset(self):
        return np.array((0.0, 0.0, -0.922))

    @property
    def horizontal_radius(self):
        return 0.25


@register_base
class RethinkMinimalMount(RobotBaseModel):
    """robosuite bases/rethink_minimal_mount.py (Baxter's): top_offset
    (0,0,-0.01), bottom_offset (0,0,-0.9)."""

    card_name = "rethink_minimal_mount"

    @property
    def top_offset(self):
        return np.array((0.0, 0.0, -0.01))

    @property
    def bottom_offset(self):
        return np.array((0.0, 0.0, -0.9))

    @property
    def horizontal_radius(self):
        return 0.25


@register_base
class NullMount(RobotBaseModel):
    """robosuite bases/null_mount.py: one empty body, zero offsets."""

    card_name = "null_mount"


@register_base
class OmronMobileBase(RobotBaseModel):
    """robosuite bases/omron_mobile_base.py: planar joints with velocity
    actuators and a torso lift."""

    card_name = "omron_mobile_base"
    mount = False

    @property
    def bottom_offset(self):
        return np.array((0.0, 0.0, -0.892))

    @property
    def horizontal_radius(self):
        return 0.4


@register_base
class NullMobileBase(RobotBaseModel):
    """robosuite bases/null_mobile_base.py: the planar joints alone."""

    card_name = "null_mobile_base"
    mount = False


@register_base
class FloatingLeggedBase(RobotBaseModel):
    """robosuite bases/floating_legged_base.py: a bare support body carrying
    the planar joints and their velocity actuators."""

    card_name = "floating_legged_base"
    mount = False


@register_base
class NoActuationBase(RobotBaseModel):
    """robosuite bases/no_actuation_base.py: a mobile base with no joints
    and no actuators, for robots that stand on their own."""

    card_name = "no_actuation_base"
    mount = False


@register_base
class Spot(RobotBaseModel):
    """robosuite bases/spot_base.py:7-28: the legged Spot body, a free root
    joint and 12 actuated leg joints, prefixed 'leg{idn}_'
    (leg_base_model.py:23)."""

    card_name = "spot"
    mount = False
    # the raw leg position servo (kp, kv) of Spot's model (its "spot"
    # default class, <position kp="500" kv="40">): LeggedRobot drives the
    # legs with it
    leg_servo = (500.0, 40.0)

    @property
    def naming_prefix(self):
        return f"leg{self.idn}_"

    @property
    def leg_joints(self) -> List[str]:
        return self._own_joints(lambda j: j.type != "free" and "leg" in j.name)

    @property
    def init_qpos(self):
        # spot_base.py:26-28: (hx, hy, kn) for fr, fl, hr, hl
        return np.array([0.0, 0.9, -1.8] * 4)

    @property
    def bottom_offset(self):
        # the foot spheres' centres at init_qpos sit 0.648 below the
        # placement origin, plus the 0.036 foot radius: the robot stands
        # on the floor at the reset
        return np.array((0.0, 0.0, -0.684))

    @property
    def horizontal_radius(self):
        return 0.1


@register_base
class SpotFloating(RobotBaseModel):
    """robosuite bases/spot_base.py:31-56: the Spot body with its free joint,
    leg joints and leg actuators removed (the legs rigid) and planar joints
    with velocity actuators on the root (leg_base_model.py:26-135; robosuite's
    axes: forward +y, side +x in Spot's body frame)."""

    card_name = "spot"
    mount = False

    @property
    def naming_prefix(self):
        return f"leg{self.idn}_"

    def _customize_spec(self, ms):
        root = self._root
        for b in root.walk():
            b.joints = [j for j in b.joints if j.type != "free" and "leg" not in j.name]
        ms.actuators = [a for a in ms.actuators if "leg" not in a.name]
        root.joints[0:0] = [
            S.JointSpec("joint_mobile_forward", type="slide", axis=(0, 1, 0), frictionloss=250.0),
            S.JointSpec("joint_mobile_side", type="slide", axis=(1, 0, 0), frictionloss=250.0),
            S.JointSpec("joint_mobile_yaw", type="hinge", axis=(0, 0, 1), frictionloss=250.0),
        ]
        for nm, rng, kv in (("mobile_forward", 1.0, 1000.0), ("mobile_side", 1.0, 1000.0),
                            ("mobile_yaw", 1.5, 1500.0)):
            ms.actuators.append(S.ActuatorSpec(name=f"actuator_{nm}", joint=f"joint_{nm}", kind="velocity",
                                               ctrlrange=(-rng, rng), forcerange=(-600.0, 600.0), kv=kv))

    @property
    def horizontal_radius(self):
        return 0.1
