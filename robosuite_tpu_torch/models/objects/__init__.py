"""Task objects (robosuite models/objects/{objects.py,
generated_objects.py, primitive/box.py}), trimmed to the box primitive and
the single body of several boxes (CompositeBoxObject).

Naming follows robosuite exactly: body "<name>_main", geoms "<name>_g0"
(+ "_g0_vis" visual duplicate), free joint "<name>_joint0" (none for a
fixed object, joints=None), site "<name>_default_site".
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from robosuite_tpu_torch.models import spec as S


class MujocoObject:
    """Base object: a spec subtree factory with robosuite's object contract
    (root body, bottom/top offsets)."""

    def __init__(self, name: str, joints="default"):
        self.name = name
        # "default": one free joint; None or []: a body fixed in the world
        self.joints = [dict(type="free")] if joints == "default" else list(joints or [])
        self._root: Optional[S.BodySpec] = None

    @property
    def naming_prefix(self):
        return f"{self.name}_"

    @property
    def root_body(self):
        return self.naming_prefix + "main"

    @property
    def default_site(self):
        return self.naming_prefix + "default_site"

    def get_obj(self) -> S.BodySpec:
        if self._root is None:
            self._root = self._build()
        return self._root

    def _build(self) -> S.BodySpec:
        raise NotImplementedError

    def _make_root(self) -> S.BodySpec:
        b = S.BodySpec(self.root_body)
        for i, j in enumerate(self.joints):
            b.add_joint(S.JointSpec(name=f"{self.naming_prefix}joint{i}", **dict(dict(type="free"), **j)))
        b.add_site(S.SiteSpec(self.default_site, size=(0.002,), rgba=(1, 0, 0, 0)))
        return b

    @property
    def contact_geoms(self) -> List[str]:
        return [g.name for b in self.get_obj().walk() for g in b.geoms if g.contype or g.conaffinity]


class BoxObject(MujocoObject):
    """robosuite objects/primitive/box.py (generated_objects.py:603-760)."""

    def __init__(self, name, size=None, rgba=(1, 0, 0, 1), density=1000.0,
                 friction=(1.0, 0.005, 0.0001), solref=(0.02, 1.0),
                 solimp=(0.9, 0.95, 0.001, 0.5, 2.0), size_min=None, size_max=None, rng=None):
        super().__init__(name)
        if size is None:
            if size_min is not None and size_max is not None:
                rng = rng or np.random.default_rng()
                size = rng.uniform(np.asarray(size_min, dtype=np.float64), np.asarray(size_max, dtype=np.float64))
            else:
                size = [0.05, 0.05, 0.05]
        self.size = np.asarray(size, dtype=np.float64).reshape(-1)[:3]
        self.rgba = rgba
        self.density = density
        self.friction = friction
        self.solref = solref
        self.solimp = solimp

    def _build(self):
        b = self._make_root()
        b.add_geom(
            S.GeomSpec(
                f"{self.naming_prefix}g0", type="box", size=self.size, density=self.density,
                friction=self.friction, solref=self.solref, solimp=self.solimp, group=0, rgba=self.rgba,
            )
        )
        b.add_geom(
            S.GeomSpec(
                f"{self.naming_prefix}g0_vis", type="box", size=self.size, mass=0.0,
                contype=0, conaffinity=0, group=1, rgba=self.rgba,
            )
        )
        return b

    @property
    def bottom_offset(self):
        return np.array([0, 0, -self.size[2]])

    @property
    def top_offset(self):
        return np.array([0, 0, self.size[2]])

    @property
    def horizontal_radius(self):
        return float(np.linalg.norm(self.size[0:2], 2))


class CompositeBoxObject(MujocoObject):
    """Several boxes on one body (robosuite generated_objects.py
    CompositeObject :293-600), their half sizes and centres in the body's
    frame, unturned."""

    def __init__(self, name, geom_sizes, geom_locations, geom_names, density=1000.0, joints="default"):
        super().__init__(name, joints=joints)
        self.geom_sizes = [np.asarray(s, dtype=np.float64) for s in geom_sizes]
        self.geom_locations = [np.asarray(p, dtype=np.float64) for p in geom_locations]
        self.geom_names_in = geom_names
        self.density = density

    def _build(self):
        b = self._make_root()
        for sz, pos, nm in zip(self.geom_sizes, self.geom_locations, self.geom_names_in):
            b.add_geom(S.GeomSpec(f"{self.naming_prefix}{nm}", type="box", size=sz, pos=pos, density=self.density,
                                  friction=(1, 0.005, 0.0001), group=0, rgba=(0.7, 0.7, 0.7, 1)))
        return b

    @property
    def bottom_offset(self):
        return np.array([0, 0, min(p[2] - s[2] for p, s in zip(self.geom_locations, self.geom_sizes))])

    @property
    def top_offset(self):
        return np.array([0, 0, max(p[2] + s[2] for p, s in zip(self.geom_locations, self.geom_sizes))])

    @property
    def horizontal_radius(self):
        return max(float(np.linalg.norm(p[:2]) + np.max(s[:2])) for p, s in zip(self.geom_locations, self.geom_sizes))


# robosuite's name: generated_objects.py CompositeObject, one body of several geoms
CompositeObject = CompositeBoxObject
