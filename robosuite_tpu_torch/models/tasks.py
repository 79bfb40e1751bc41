"""Task assembly: arena + robots + objects -> one world ModelSpec.

robosuite models/tasks/task.py:60-123 (ManipulationTask XML merge) as
spec-tree grafting. Child order matches robosuite's merged worlds (arena
bodies, eef target bodies, robots, objects), so joint / body / actuator
ordering — and therefore the qpos/qvel layout — lines up with the JAX
package's worlds.
"""

from __future__ import annotations

import numpy as np

from robosuite_tpu_torch import macros
from robosuite_tpu_torch.models import spec as S


def make_world_option():
    """Physics options stamped into every world (robosuite
    models/assets/base.xml:3-5 + world.py:14-15)."""
    return S.OptionSpec(
        timestep=macros.SIMULATION_TIMESTEP,
        gravity=(0, 0, -9.81),
        impratio=20.0,
        density=1.2,
        viscosity=0.00002,
    )


def _add_eef_targets(ms: S.ModelSpec):
    """The eef target bodies robosuite's RobotEnv injects into every merged
    world (static, visual only)."""
    for side in ("left", "right"):
        b = ms.worldbody.add_body(S.BodySpec(f"{side}_eef_target", pos=(0, 0, -1)))
        b.add_geom(
            S.GeomSpec(f"{side}_eef_target_box", type="box", size=(0.05, 0.05, 0.05), contype=0, conaffinity=0, group=2, rgba=(0.898, 0.420, 0.435, 0.5))
        )
        b.add_geom(
            S.GeomSpec(f"{side}_eef_target_sphere", type="sphere", size=(0.01,), contype=0, conaffinity=0, group=2, rgba=(0.898, 0.420, 0.435, 0.8))
        )


class ManipulationTask:
    """Composes the full manipulation world (robosuite tasks/task.py:60-123).

    Args:
        mujoco_arena: Arena instance (its spec is consumed)
        mujoco_robots: list of ManipulatorModel (already based/grippered)
        mujoco_objects: list of objects, one object, or None
    """

    def __init__(self, mujoco_arena, mujoco_robots, mujoco_objects=()):
        robots = mujoco_robots if isinstance(mujoco_robots, (list, tuple)) else [mujoco_robots]
        if mujoco_objects is None:
            mujoco_objects = ()
        objects = mujoco_objects if isinstance(mujoco_objects, (list, tuple)) else [mujoco_objects]

        ms = S.ModelSpec("manipulation_task", make_world_option())
        arena_wb = mujoco_arena.spec.worldbody
        ms.worldbody.geoms.extend(arena_wb.geoms)
        ms.worldbody.sites.extend(arena_wb.sites)
        ms.worldbody.cameras.extend(arena_wb.cameras)
        ms.worldbody.lights.extend(arena_wb.lights)
        ms.worldbody.children.extend(arena_wb.children)

        _add_eef_targets(ms)

        for robot in robots:
            ms.worldbody.children.append(robot.root_subtree())
            ms.actuators.extend(robot.actuators())
            ms.equalities.extend(robot.equalities())
            ms.tendons.extend(robot.tendons())

        for obj in objects:
            ms.worldbody.children.append(obj.get_obj())
            if hasattr(obj, "meshes"):
                ms.meshes.update(obj.meshes())

        self.spec = ms

    def compile(self, dtype=np.float32):
        return self.spec.compile(dtype=dtype)
