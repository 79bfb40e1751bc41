"""Arenas: procedural workspaces (robosuite models/arenas/*.py), trimmed
to the empty, table, multi-table, bins, pegs and wipe arenas. Same geometry and names as
robosuite's table_arena.xml, bins_arena.xml and pegs_arena.xml, so the
qpos/geom layout lines up with the JAX package."""

from __future__ import annotations

import numpy as np

from robosuite_tpu_torch.models import spec as S


class Arena:
    """Base arena (robosuite arenas/arena.py:21-160)."""

    def __init__(self):
        self.spec = S.ModelSpec("arena", S.OptionSpec())

    def set_origin(self, offset):
        """Shift all top-level bodies/geoms (robosuite arena.py:91-103)."""
        offset = np.asarray(offset, dtype=np.float64)
        for b in self.spec.worldbody.children:
            b.pos = np.asarray(b.pos) + offset
        for g in self.spec.worldbody.geoms:
            g.pos = np.asarray(g.pos) + offset

    def add_standard_light(self):
        """The arenas' shared key light (pos 1,1,1.5 dir -0.2,-0.2,-1)."""
        self.spec.worldbody.add_light(
            S.LightSpec(
                pos=(1.0, 1.0, 1.5), dir=(-0.2, -0.2, -1.0),
                directional=True, specular=(0.3, 0.3, 0.3), castshadow=False,
            )
        )

    def add_standard_cameras(self):
        """frontview/birdview/agentview/sideview (robosuite table_arena.xml)."""
        wb = self.spec.worldbody
        wb.add_camera(S.CameraSpec("frontview", pos=(1.6, 0, 1.45), quat=(0.56, 0.43, 0.43, 0.56)))
        wb.add_camera(S.CameraSpec("birdview", pos=(-0.2, 0, 3.0), quat=(0.7071, 0, 0, 0.7071)))
        wb.add_camera(S.CameraSpec("agentview", pos=(0.5, 0, 1.35), quat=(0.653, 0.271, 0.271, 0.653)))
        wb.add_camera(
            S.CameraSpec(
                "sideview",
                pos=(-0.05651774593317116, 1.2761224129427358, 1.4879572214102434),
                quat=(0.009905065491771751, 0.006877963156909582, 0.5912228352893879, 0.806418094001364),
            )
        )


class EmptyArena(Arena):
    """robosuite arenas/empty_arena.py: the floor only."""

    def __init__(self):
        super().__init__()
        self.spec.worldbody.add_geom(
            S.GeomSpec("floor", type="plane", size=(3, 3, 0.125), group=1, friction=(1, 0.005, 0.0001)))
        self.add_standard_light()
        self.add_standard_cameras()


class TableArena(Arena):
    """robosuite arenas/table_arena.py:7-97: table + floor + visual walls."""

    def __init__(
        self,
        table_full_size=(0.8, 0.8, 0.05),
        table_friction=(1, 0.005, 0.0001),
        table_offset=(0, 0, 0.8),
        has_legs=True,
    ):
        super().__init__()
        self.table_full_size = np.array(table_full_size)
        self.table_half_size = self.table_full_size / 2
        self.table_friction = np.array(table_friction)
        self.table_offset = np.array(table_offset)
        self.bottom_pos = np.zeros(3)
        self.center_pos = self.bottom_pos + np.array([0, 0, -self.table_half_size[2]]) + self.table_offset

        wb = self.spec.worldbody
        wb.add_geom(S.GeomSpec("floor", type="plane", size=(3, 3, 0.125), group=1, friction=(1, 0.005, 0.0001)))

        # visual walls (contype/conaffinity 0; kept for geom-layout parity)
        walls = [
            ("wall_leftcorner_visual", (-1.25, 2.25, 1.5), (0.6532815, 0.6532815, 0.2705981, 0.2705981), (1.06, 1.5, 0.01)),
            ("wall_rightcorner_visual", (-1.25, -2.25, 1.5), (0.6532815, 0.6532815, -0.2705981, -0.2705981), (1.06, 1.5, 0.01)),
            ("wall_left_visual", (1.25, 3, 1.5), (0.7071, 0.7071, 0, 0), (1.75, 1.5, 0.01)),
            ("wall_right_visual", (1.25, -3, 1.5), (0.7071, -0.7071, 0, 0), (1.75, 1.5, 0.01)),
            ("wall_rear_visual", (-2, 0, 1.5), (0.5, 0.5, 0.5, 0.5), (1.5, 1.5, 0.01)),
            ("wall_front_visual", (3, 0, 1.5), (0.5, 0.5, -0.5, -0.5), (3, 1.5, 0.01)),
        ]
        for name, pos, quat, size in walls:
            wb.add_geom(S.GeomSpec(name, type="box", pos=pos, quat=quat, size=size, contype=0, conaffinity=0, group=1))

        table = wb.add_body(S.BodySpec("table", pos=self.center_pos))
        table.add_geom(
            S.GeomSpec("table_collision", type="box", size=self.table_half_size, friction=self.table_friction, group=0)
        )
        table.add_geom(
            S.GeomSpec("table_visual", type="box", size=self.table_half_size, contype=0, conaffinity=0, group=1)
        )
        table.add_site(S.SiteSpec("table_top", pos=(0, 0, self.table_half_size[2]), size=(0.001, 0.001, 0.001)))
        if has_legs:
            delta_x = [0.1, -0.1, -0.1, 0.1]
            delta_y = [0.1, 0.1, -0.1, -0.1]
            for i, (dx, dy) in enumerate(zip(delta_x, delta_y)):
                x = np.sign(dx) * self.table_half_size[0] - dx if self.table_half_size[0] > abs(dx * 2.0) else 0.0
                y = np.sign(dy) * self.table_half_size[1] - dy if self.table_half_size[1] > abs(dy * 2.0) else 0.0
                z = (self.table_offset[2] - self.table_half_size[2]) / 2.0
                table.add_geom(
                    S.GeomSpec(
                        f"table_leg{i+1}_visual", type="cylinder", size=(0.025, z), pos=(x, y, -z),
                        contype=0, conaffinity=0, group=1,
                    )
                )
        self.add_standard_light()
        self.add_standard_cameras()


class MultiTableArena(Arena):
    """robosuite arenas/multi_table_arena.py (TwoArmTransport): the floor and
    N tables, table i's top at table_offsets[i] with a "table{i}_top"
    site. Its lights and cameras are left out: the port renders nothing."""

    def __init__(self, table_offsets, table_full_sizes=(0.8, 0.8, 0.05), table_frictions=(1, 0.005, 0.0001)):
        super().__init__()
        self.table_offsets = np.array(table_offsets).reshape(-1, 3)
        n = self.table_offsets.shape[0]
        self.table_full_sizes = np.broadcast_to(np.array(table_full_sizes), (n, 3)).copy()
        self.table_half_sizes = self.table_full_sizes / 2
        wb = self.spec.worldbody
        wb.add_geom(S.GeomSpec("floor", type="plane", size=(3, 3, 0.125), group=1, friction=(1, 0.005, 0.0001)))
        for i in range(n):
            half = self.table_half_sizes[i]
            t = wb.add_body(S.BodySpec(f"table{i}", pos=self.table_offsets[i] - np.array([0, 0, half[2]])))
            t.add_geom(S.GeomSpec(f"table{i}_collision", type="box", size=half, friction=np.array(table_frictions),
                                  group=0))
            t.add_site(S.SiteSpec(f"table{i}_top", pos=(0, 0, half[2]), size=(0.001, 0.001, 0.001)))


class BinsArena(Arena):
    """robosuite arenas/bins_arena.py: two bins on pedestals (PickPlace)."""

    def __init__(self, bin1_pos=(0.1, -0.25, 0.8), table_full_size=(0.39, 0.49, 0.82),
                 table_friction=(1, 0.005, 0.0001)):
        super().__init__()
        self.table_full_size = np.array(table_full_size)
        self.table_half_size = self.table_full_size / 2
        self.bin1_pos = np.array(bin1_pos)
        self.bin2_pos = self.bin1_pos + np.array([0.0, 0.49, 0.0])
        wb = self.spec.worldbody
        wb.add_geom(S.GeomSpec("floor", type="plane", size=(3, 3, 0.125), group=1, friction=(1, 0.005, 0.0001)))
        wall_h, wall_t = 0.05, 0.01
        for b_i, bpos in enumerate((self.bin1_pos, self.bin2_pos)):
            body = wb.add_body(S.BodySpec(f"bin{b_i + 1}", pos=bpos))
            hx, hy = self.table_half_size[0], self.table_half_size[1]
            body.add_geom(S.GeomSpec(f"bin{b_i + 1}_base", type="box", size=(hx, hy, 0.01), pos=(0, 0, -0.01),
                                     friction=np.array(table_friction)))
            for w_i, (wx, wy, sx, sy) in enumerate(
                    [(-hx, 0, wall_t, hy), (hx, 0, wall_t, hy), (0, -hy, hx, wall_t), (0, hy, hx, wall_t)]):
                body.add_geom(S.GeomSpec(f"bin{b_i + 1}_wall{w_i}", type="box", size=(sx, sy, wall_h),
                                         pos=(wx, wy, wall_h)))
            # the pedestal under the bin (visual)
            body.add_geom(S.GeomSpec(f"bin{b_i + 1}_pedestal", type="box", size=(hx, hy, bpos[2] / 2 - 0.02),
                                     pos=(0, 0, -bpos[2] / 2), contype=0, conaffinity=0, group=1))
        self.add_standard_light()
        self.add_standard_cameras()


class PegsArena(TableArena):
    """robosuite arenas/pegs_arena.py (NutAssembly): the table and two pegs,
    a box (peg1, for the square nut) and a cylinder (peg2, the round nut),
    at pegs_arena.xml's positions and sizes."""

    def __init__(self, table_full_size=(0.45, 0.69, 0.05), table_friction=(1, 0.005, 0.0001),
                 table_offset=(0, 0, 0.8)):
        super().__init__(table_full_size=table_full_size, table_friction=table_friction, table_offset=table_offset)
        wb = self.spec.worldbody
        peg1 = wb.add_body(S.BodySpec("peg1", pos=(0.23, 0.1, 0.85)))
        peg1.add_geom(S.GeomSpec("peg1_g0", type="box", size=(0.016, 0.016, 0.1), friction=(1, 0.005, 0.0001)))
        peg2 = wb.add_body(S.BodySpec("peg2", pos=(0.23, -0.1, 0.85)))
        peg2.add_geom(S.GeomSpec("peg2_g0", type="cylinder", size=(0.02, 0.1), friction=(1, 0.005, 0.0001)))


class WipeArena(TableArena):
    """robosuite arenas/wipe_arena.py (Wipe): the table and num_markers dirt
    markers, each a body "contact<i>" under the table with a visual
    cylinder site, along a 2D random walk over the table top
    (sample_path_pos) drawn from np.random.default_rng(seed) in the JAX
    package's order, so a seed gives its markers bit for bit."""

    def __init__(self, table_full_size=(0.8, 0.8, 0.05), table_friction=(0.01, 0.005, 0.0001),
                 table_offset=(0, 0, 0.8), num_markers=10, line_width=0.04, coverage_factor=0.9, seed=None):
        super().__init__(table_full_size=table_full_size, table_friction=table_friction, table_offset=table_offset)
        self.num_markers = num_markers
        self.line_width = line_width
        self.coverage_factor = coverage_factor
        rng = np.random.default_rng(seed)
        table = self.spec.worldbody.find_body("table")
        pos = np.array([0.0, 0.0])
        direction = rng.uniform(-np.pi, np.pi)
        half = self.table_half_size
        lim = half[:2] * coverage_factor - line_width / 2
        self.marker_names = []
        for i in range(num_markers):
            body = S.BodySpec(f"contact{i}", pos=(pos[0], pos[1], half[2]))
            body.add_site(S.SiteSpec(f"contact{i}_site", pos=(0, 0, 0), size=(line_width / 2, 0.001, 0.001),
                                     type="cylinder", rgba=(1, 1, 1, 1)))
            table.children.append(body)
            self.marker_names.append(f"contact{i}")
            if rng.uniform() > 0.7:
                direction += rng.normal(0, 0.5)
            posnew = pos + 0.005 * np.array([np.cos(direction), np.sin(direction)])
            while abs(posnew[0]) >= lim[0] or abs(posnew[1]) >= lim[1]:
                direction += rng.normal(0, 0.5)
                posnew = pos + 0.005 * np.array([np.cos(direction), np.sin(direction)])
            pos = posnew
