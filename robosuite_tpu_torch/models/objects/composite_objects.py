"""Composite task objects built from primitives (the JAX package's
models/objects/composite_objects.py; robosuite models/objects/composite/
and composite_body/): the pot with handles (TwoArmLift), the hammer
(TwoArmHandover, TwoArmTransport's payload), the stand, hook frame and
ratcheting wrench (ToolHang), and the bin and its lid (TwoArmTransport)."""

from __future__ import annotations

import numpy as np

from robosuite_tpu_torch.models import spec as S
from robosuite_tpu_torch.models.objects import CompositeBoxObject, MujocoObject


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


class HammerObject(MujocoObject):
    """robosuite objects/composite/hammer.py, as the JAX package trims it: a
    cylinder handle along y and a box head at its +y end (twice the
    handle's density), a site at the handle's centre."""

    def __init__(self, name, handle_radius=0.015, handle_length=0.24, head_density_ratio=2.0, density=1000):
        super().__init__(name)
        self.handle_radius = handle_radius
        self.handle_length = handle_length
        self.head_half = np.array((0.03, 0.09, 0.03))
        self.density = density
        self.head_density_ratio = head_density_ratio

    def _build(self):
        b = self._make_root()
        p = self.naming_prefix
        fr = (1.0, 0.005, 0.0001)
        b.add_geom(S.GeomSpec(f"{p}handle", type="cylinder", size=(self.handle_radius, self.handle_length / 2),
                              quat=(0.7071068, 0.7071068, 0, 0), density=self.density, friction=fr))
        b.add_geom(S.GeomSpec(f"{p}head", type="box", size=self.head_half,
                              pos=(0, self.handle_length / 2 + self.head_half[1] * 0.3, 0),
                              quat=(0.7071068, 0, 0, 0.7071068), density=self.density * self.head_density_ratio,
                              friction=fr))
        b.add_site(S.SiteSpec(f"{p}handle_site", pos=(0, 0, 0), size=(0.005,), rgba=(1, 0, 0, 0)))
        return b

    @property
    def handle_geoms(self):
        return [f"{self.naming_prefix}handle"]

    @property
    def important_sites(self):
        return {"handle": f"{self.naming_prefix}handle_site"}

    @property
    def bottom_offset(self):
        return np.array([0, 0, -self.head_half[0]])

    @property
    def top_offset(self):
        return np.array([0, 0, self.head_half[0]])

    @property
    def horizontal_radius(self):
        return self.handle_length / 2 + 0.12


class StandWithMount(CompositeBoxObject):
    """robosuite objects/composite/stand_with_mount.py: a base plate, a
    post and four walls that form a square mount cavity at the top."""

    def __init__(self, name):
        base, post, wall = (0.07, 0.07, 0.01), (0.015, 0.015, 0.095), (0.0025, 0.025, 0.06)
        across, along = (wall[1], wall[0], wall[2]), (wall[0], wall[1], wall[2])
        z_wall = base[2] * 2 + post[2] * 2 + wall[2] - 0.02
        super().__init__(name, [base, post, across, across, along, along],
                         [(0, 0, 0), (0, 0, base[2] + post[2]), (0, 0.0225, z_wall), (0, -0.0225, z_wall),
                          (0.0225, 0, z_wall), (-0.0225, 0, z_wall)],
                         geom_names=["base", "post", "w0", "w1", "w2", "w3"], density=2000.0)


class HookFrame(CompositeBoxObject):
    """robosuite objects/composite/hook_frame.py: a vertical stem, a
    horizontal arm and the hook's tip, with the hang and intersection
    sites."""

    def __init__(self, name):
        stem, arm, tip = (0.0125, 0.0125, 0.12), (0.05, 0.0125, 0.0125), (0.0125, 0.0125, 0.02)
        super().__init__(name, [stem, arm, tip], [(0, 0, 0), (0.05 - 0.0125, 0, 0.12 + 0.0125),
                                                  (0.05 * 2 - 0.025, 0, 0.12 - 0.02)],
                         geom_names=["stem", "arm", "tip"], density=1500.0)
        self._hang_local = np.array([0.075, 0.0, 0.10])

    def _build(self):
        b = super()._build()
        p = self.naming_prefix
        b.add_site(S.SiteSpec(f"{p}hang_site", pos=self._hang_local, size=(0.005,), rgba=(0, 1, 0, 0)))
        b.add_site(S.SiteSpec(f"{p}intersection_site", pos=(0, 0, -0.12), size=(0.005,), rgba=(0, 1, 0, 0)))
        return b

    @property
    def important_sites(self):
        return {"hang": f"{self.naming_prefix}hang_site", "intersection": f"{self.naming_prefix}intersection_site"}


class RatchetingWrench(CompositeBoxObject):
    """robosuite objects/composite_body/ratcheting_wrench.py: a bar with a
    ring at one end (an open square of four thin boxes), its site at the
    ring's centre."""

    def __init__(self, name):
        bar, ring_w = (0.055, 0.01, 0.006), (0.002, 0.016, 0.006)
        across, along = (ring_w[1], ring_w[0], ring_w[2]), (ring_w[0], ring_w[1], ring_w[2])
        x0 = -0.055 - 0.014
        super().__init__(name, [bar, across, across, along, along],
                         [(0, 0, 0), (x0, 0.014, 0), (x0, -0.014, 0), (x0 + 0.014, 0, 0), (x0 - 0.014, 0, 0)],
                         geom_names=["bar", "r0", "r1", "r2", "r3"], density=3000.0)

    def _build(self):
        b = super()._build()
        b.add_site(S.SiteSpec(f"{self.naming_prefix}ring_site", pos=(-0.069, 0, 0), size=(0.005,), rgba=(0, 0, 1, 0)))
        return b

    @property
    def important_sites(self):
        return {"ring": f"{self.naming_prefix}ring_site"}


class BinObject(CompositeBoxObject):
    """robosuite objects/composite/bin.py: an open-top bin, a base plate and
    four walls; joints=None fixes it in the world."""

    def __init__(self, name, half=(0.09, 0.09, 0.05), thickness=0.005, density=500.0, joints=None):
        hx, hy, hz = half
        t = thickness
        super().__init__(name, [(hx, hy, t), (hx, t, hz), (hx, t, hz), (t, hy, hz), (t, hy, hz)],
                         [(0, 0, -hz + t), (0, -hy + t, 0), (0, hy - t, 0), (-hx + t, 0, 0), (hx - t, 0, 0)],
                         geom_names=["base", "w0", "w1", "w2", "w3"], density=density, joints=joints)


class LidObject(CompositeBoxObject):
    """robosuite objects/composite/lid.py: a flat plate with a handle bar on
    top."""

    def __init__(self, name, half=(0.09, 0.09, 0.005), density=300.0):
        hx, hy, hz = half
        super().__init__(name, [(hx, hy, hz), (0.04, 0.01, 0.01)], [(0, 0, 0), (0, 0, hz + 0.02)],
                         geom_names=["plate", "handle"], density=density)

    @property
    def handle_geoms(self):
        return [f"{self.naming_prefix}handle"]
