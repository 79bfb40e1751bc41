"""Composite task objects built from primitives (the JAX package's
models/objects/composite_objects.py; robosuite models/objects/composite/),
trimmed to the pot with handles of TwoArmLift."""

from __future__ import annotations

import numpy as np

from robosuite_tpu_torch.models import spec as S
from robosuite_tpu_torch.models.objects import MujocoObject


class PotWithHandlesObject(MujocoObject):
    """robosuite objects/composite/pot_with_handles.py: an open box (a base
    and four walls) with a U-shaped handle of three bars on each y side;
    sites at the centre and at each handle's crossbar."""

    def __init__(self, name, body_half_size=(0.07, 0.07, 0.07), handle_radius=0.01, handle_length=0.09,
                 handle_width=0.09, handle_friction=1.0, density=1000, thickness=0.01):
        super().__init__(name)
        self.body_half_size = np.array(body_half_size)
        self.thickness = thickness
        self.handle_radius = handle_radius
        self.handle_length = handle_length
        self.handle_width = handle_width
        self.handle_friction = handle_friction
        self.density = density

    def _build(self):
        b = self._make_root()
        p = self.naming_prefix
        hx, hy, hz = self.body_half_size
        t = self.thickness / 2
        fr = (1.0, 0.005, 0.0001)
        b.add_geom(S.GeomSpec(f"{p}base", type="box", size=(hx, hy, t), pos=(0, 0, -hz + t), density=self.density,
                              friction=fr))
        for nm, sz, pos in (("wall_y0", (hx, t, hz), (0, -hy + t, 0)), ("wall_y1", (hx, t, hz), (0, hy - t, 0)),
                            ("wall_x0", (t, hy, hz), (-hx + t, 0, 0)), ("wall_x1", (t, hy, hz), (hx - t, 0, 0))):
            b.add_geom(S.GeomSpec(f"{p}{nm}", type="box", size=sz, pos=pos, density=self.density, friction=fr))
        handle_z = hz - self.handle_radius
        hfr = (self.handle_friction, 0.005, 0.0001)
        r = self.handle_radius
        for side_i, side in enumerate((1.0, -1.0)):
            cy = side * (hy + self.handle_length)
            pre = f"{p}handle{side_i}"
            b.add_geom(S.GeomSpec(f"{pre}_c", type="box", size=(self.handle_width / 2, r, r), pos=(0, cy, handle_z),
                                  density=self.density, friction=hfr))
            for sx in (-1.0, 1.0):  # the struts from the crossbar to the rim
                b.add_geom(S.GeomSpec(f"{pre}_{'m' if sx < 0 else 'p'}", type="box",
                                      size=(r, self.handle_length / 2, r),
                                      pos=(sx * self.handle_width / 2, side * (hy + self.handle_length / 2), handle_z),
                                      density=self.density, friction=hfr))
            b.add_site(S.SiteSpec(f"{pre}_site", pos=(0, cy, handle_z), size=(0.005,), rgba=(1, 0, 0, 0)))
        b.add_site(S.SiteSpec(f"{p}center", pos=(0, 0, 0), size=(0.005,), rgba=(0, 0, 1, 0)))
        return b

    @property
    def handle_geoms(self):
        """{handle index: its three bars' geom names}."""
        return {i: [f"{self.naming_prefix}handle{i}_{s}" for s in ("c", "m", "p")] for i in (0, 1)}

    @property
    def important_sites(self):
        p = self.naming_prefix
        return {"handle0": f"{p}handle0_site", "handle1": f"{p}handle1_site", "center": f"{p}center"}

    @property
    def handle_distance(self):
        return 2.0 * (self.body_half_size[1] + self.handle_length)

    @property
    def bottom_offset(self):
        return np.array([0, 0, -self.body_half_size[2]])

    @property
    def top_offset(self):
        return np.array([0, 0, self.body_half_size[2]])

    @property
    def horizontal_radius(self):
        return float(np.sqrt(self.body_half_size[0] ** 2 + (self.body_half_size[1] + self.handle_length) ** 2))
