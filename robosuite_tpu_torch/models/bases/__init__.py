"""Robot bases (robosuite models/bases/*.py), trimmed to the fixed mounts:
RethinkMount (Panda, Sawyer, SpotArm), RethinkMinimalMount (Baxter) and
NullMount (a bare body)."""

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
    """A fixed mount: a card subtree hung under the robot root."""

    card_name: str = None

    def __init__(self, idn=0):
        self.idn = idn
        ms = spec_from_card(self.card_name)
        assert len(ms.worldbody.children) == 1
        self._root = ms.worldbody.children[0]
        self._root.apply_prefix(self.naming_prefix)
        self._actuators: List[S.ActuatorSpec] = [
            S.ActuatorSpec(
                name=self.naming_prefix + a.name, joint=self.naming_prefix + a.joint, kind=a.kind,
                gear=a.gear, ctrlrange=a.ctrlrange, forcerange=a.forcerange, kp=a.kp, kv=a.kv,
            )
            for a in ms.actuators
        ]

    @property
    def naming_prefix(self):
        # robosuite mount_model.py:10
        return f"fixed_mount{self.idn}_"

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
