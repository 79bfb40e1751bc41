"""Hull-backed mesh objects: robosuite's pick-place items with convex-mesh
collision (the JAX package's models/objects/hull_objects.py; robosuite
models/objects/xml_objects.py MilkObject, BreadObject, CerealObject,
CanObject).

Each object loads its hull card (hulls/*.json: vertices, outward face
planes, volume, centre of mass and unit-density inertia) and builds a free
body with ONE mesh geom carrying robosuite's contact parameters (the same
in each object's XML: solimp "0.998 0.998 0.001", solref "0.001 1",
friction "0.95 0.3 0.1"). Mass and inertia come from the hull's moments
at the card's density (models/model.py _geom_mass_inertia).
"""

from __future__ import annotations

import functools
import json
import os

import numpy as np

from robosuite_tpu_torch.models import spec as S
from robosuite_tpu_torch.models.objects import MujocoObject

_HULL_DIR = os.path.join(os.path.dirname(__file__), "hulls")


@functools.lru_cache(maxsize=None)
def load_hull(hull_name: str) -> dict:
    with open(os.path.join(_HULL_DIR, f"{hull_name}.json")) as f:
        return json.load(f)


class HullObject(MujocoObject):
    """A free mesh object colliding through its convex hull."""

    hull_name: str = None
    rgba = (0.7, 0.7, 0.7, 1.0)

    def __init__(self, name=None):
        super().__init__(name or self.hull_name)
        self.hull = load_hull(self.hull_name)
        self._verts = np.asarray(self.hull["verts"], dtype=np.float64)

    @property
    def mesh_ref(self):
        return self.naming_prefix + "hull"

    def meshes(self):
        return {self.mesh_ref: self.hull}

    def _build(self):
        b = self._make_root()
        b.add_geom(S.GeomSpec(
            name=self.naming_prefix + "g0", type="mesh", mesh=self.mesh_ref,
            density=float(self.hull.get("density", 1000.0)), solref=(0.001, 1.0),
            solimp=(0.998, 0.998, 0.001, 0.5, 2.0), friction=(0.95, 0.3, 0.1), condim=4, rgba=self.rgba,
        ))
        return b

    # robosuite's object geometry contract, from the hull's extents
    @property
    def bottom_offset(self):
        return np.array([0.0, 0.0, float(self._verts[:, 2].min())])

    @property
    def top_offset(self):
        return np.array([0.0, 0.0, float(self._verts[:, 2].max())])

    @property
    def horizontal_radius(self):
        return float(np.linalg.norm(self._verts[:, :2], axis=1).max())


class MilkObject(HullObject):
    hull_name = "milk"
    rgba = (0.9, 0.9, 0.9, 1.0)


class BreadObject(HullObject):
    hull_name = "bread"
    rgba = (0.8, 0.6, 0.3, 1.0)


class CerealObject(HullObject):
    hull_name = "cereal"
    rgba = (0.8, 0.2, 0.1, 1.0)


class CanObject(HullObject):
    hull_name = "can"
    rgba = (0.9, 0.1, 0.1, 1.0)
