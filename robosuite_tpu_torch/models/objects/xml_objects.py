"""Card-backed objects (the JAX package's models/objects/xml_objects.py;
robosuite models/objects/xml_objects.py), trimmed to the door, the
plate with a hole and the two nuts.

Each wraps a committed model card (models/cards/<name>.json) extracted
from robosuite's primitive-geometry object MJCF. The door's and the
plate's joints live inside their cards; a nut gets one free joint on its
root, "<name>_joint0", as the JAX package's default joints give it.
"""

from __future__ import annotations

import copy
from typing import List

import numpy as np

from robosuite_tpu_torch.models import spec as S
from robosuite_tpu_torch.models.cards import spec_from_card
from robosuite_tpu_torch.models.objects import MujocoObject


class CardObject(MujocoObject):
    """robosuite's MujocoXMLObject: an object built from a committed card
    (objects.py:332-520), its one root renamed "<name>_main"."""

    card_name: str = None
    free_joint: bool = False  # a free joint "<name>_joint0" first on the root

    def _build(self) -> S.BodySpec:
        ms = spec_from_card(self.card_name)
        children = ms.worldbody.children
        assert len(children) == 1, f"object card {self.card_name} must have one root"
        root = copy.deepcopy(children[0])
        root.name = "main"
        root.apply_prefix(self.naming_prefix)
        if self.free_joint:
            root.joints.insert(0, S.JointSpec(name=f"{self.naming_prefix}joint0", type="free"))
        root.add_site(S.SiteSpec(self.default_site, size=(0.002,), rgba=(1, 0, 0, 0)))
        return root

    @property
    def contact_geoms(self) -> List[str]:
        return [g.name for b in self.get_obj().walk() for g in b.geoms if g.contype or g.conaffinity]


class DoorObject(CardObject):
    """robosuite xml_objects.py:236-290: a door in its frame with a handle;
    lock=True adds the latch joint on the handle. friction and damping
    override the hinge's (xml_objects.py:268-290)."""

    def __init__(self, name, friction=None, damping=None, lock=False):
        self.lock = lock
        self.card_name = "door_lock" if lock else "door"
        super().__init__(name)
        self._friction = friction
        self._damping = damping

    def _build(self):
        root = super()._build()
        for b in root.walk():
            for j in b.joints:
                if j.name.endswith("hinge"):
                    if self._friction is not None:
                        j.frictionloss = float(self._friction)
                    if self._damping is not None:
                        j.damping = float(self._damping)
        return root

    @property
    def door_body(self):
        return self.naming_prefix + "door"

    @property
    def frame_body(self):
        return self.naming_prefix + "frame"

    @property
    def latch_body(self):
        return self.naming_prefix + "latch"

    @property
    def hinge_joint(self):
        return self.naming_prefix + "hinge"

    @property
    def latch_joint(self):
        return self.naming_prefix + "latch_joint"

    @property
    def important_sites(self):
        return {"handle": self.naming_prefix + "handle"}

    @property
    def joint_names(self):
        return [j.name for b in self.get_obj().walk() for j in b.joints]

    @property
    def bottom_offset(self):
        return np.array([0, 0, -0.3])

    @property
    def top_offset(self):
        return np.array([0, 0, 0.3])

    @property
    def horizontal_radius(self):
        return 0.3


class PlateWithHoleObject(CardObject):
    """robosuite xml_objects.py PlateWithHoleObject (TwoArmPegInHole): four
    boxes around a square hole."""

    card_name = "plate_with_hole"

    @property
    def bottom_offset(self):
        return np.array([0, 0, -0.02])

    @property
    def top_offset(self):
        return np.array([0, 0, 0.02])

    @property
    def horizontal_radius(self):
        return 0.12


class _NutObject(CardObject):
    """robosuite xml_objects.py SquareNutObject / RoundNutObject
    (NutAssembly): a nut with a handle, free to move."""

    free_joint = True

    @property
    def important_sites(self):
        return {"handle": self.naming_prefix + "handle_site"}

    @property
    def bottom_offset(self):
        return np.array([0, 0, -0.01])

    @property
    def top_offset(self):
        return np.array([0, 0, 0.01])

    @property
    def horizontal_radius(self):
        return 0.06


class SquareNutObject(_NutObject):
    card_name = "square_nut"


class RoundNutObject(_NutObject):
    card_name = "round_nut"
