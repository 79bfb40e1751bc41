"""Object placement samplers, batched (the JAX package's
utils/placement.py; robosuite utils/placement_samplers.py:221-440).

robosuite rejection-samples up to 5000 times in a Python loop; here each
object draws a fixed number of candidates per scenario and takes the first
valid one, for all scenarios at once. Random numbers come from a
torch.Generator, so they are not jax.random's: parity tests inject states.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class PlacementSpec:
    """Placement parameters of one object (robosuite UniformRandomSampler,
    placement_samplers.py:150-220)."""

    name: str
    qpos_start: int                     # free-joint qpos address
    x_range: Tuple[float, float] = (0.0, 0.0)
    y_range: Tuple[float, float] = (0.0, 0.0)
    rotation: Optional[Tuple[float, float]] = None  # None -> uniform z in [0, 2 pi)
    rotation_axis: str = "z"
    reference_pos: Sequence[float] = (0.0, 0.0, 0.0)
    z_offset: float = 0.0
    bottom_offset: float = 0.0          # object bottom offset (negative)
    horizontal_radius: float = 0.0
    ensure_boundary: bool = False
    ensure_valid_placement: bool = True


def _axis_quat(axis: str, angle):
    half = angle / 2.0
    c, s, z = torch.cos(half), torch.sin(half), torch.zeros_like(angle)
    if axis == "x":
        return torch.stack([c, s, z, z], dim=-1)
    if axis == "y":
        return torch.stack([c, z, s, z], dim=-1)
    return torch.stack([c, z, z, s], dim=-1)


def sample_placements(specs: List[PlacementSpec], n: int, generator: torch.Generator, n_candidates: int = 64):
    """Non-overlapping placements of all objects in n scenarios, object by
    object (SequentialCompositeSampler semantics, robosuite :312-440).

    -> (qpos indices (7 per object), values (n, 7 per object) =
    [x, y, z, qw, qx, qy, qz] each, valid (n,) bool). `valid` is False in a
    scenario where some object had no candidate clear of the objects placed
    before it (robosuite raises RandomizationError there,
    placement_samplers.py:274-309); that scenario keeps its first candidate."""
    dev = generator.device
    placed: List[Tuple[torch.Tensor, float]] = []
    idx, vals = [], []
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    rows = torch.arange(n, device=dev)
    for spec in specs:
        (lo_x, hi_x), (lo_y, hi_y) = spec.x_range, spec.y_range
        if spec.ensure_boundary:
            r = spec.horizontal_radius
            lo_x, hi_x, lo_y, hi_y = lo_x + r, hi_x - r, lo_y + r, hi_y - r
        u = torch.rand(n, 2, n_candidates, generator=generator, device=dev)
        xs = lo_x + (hi_x - lo_x) * u[:, 0]
        ys = lo_y + (hi_y - lo_y) * u[:, 1]
        pick = torch.zeros(n, dtype=torch.long, device=dev)
        if spec.ensure_valid_placement and placed:
            ok = torch.ones_like(xs, dtype=torch.bool)
            for xy, rad in placed:
                d = torch.sqrt((xs - xy[:, 0:1]) ** 2 + (ys - xy[:, 1:2]) ** 2)
                ok = ok & (d > rad + spec.horizontal_radius)
            pick = torch.argmax(ok.to(torch.int8), dim=1)  # the first valid candidate
            valid = valid & ok.any(dim=1)
        x, y = xs[rows, pick], ys[rows, pick]
        ur = torch.rand(n, generator=generator, device=dev)
        if spec.rotation is None:
            rot = 2 * math.pi * ur
        elif isinstance(spec.rotation, (tuple, list)):
            rot = spec.rotation[0] + (spec.rotation[1] - spec.rotation[0]) * ur
        else:
            rot = torch.full_like(ur, float(spec.rotation))
        ref = spec.reference_pos
        z = torch.full_like(x, ref[2] + spec.z_offset - spec.bottom_offset)
        pos = torch.stack([x + ref[0], y + ref[1], z], dim=-1)
        placed.append((pos[:, :2], spec.horizontal_radius))
        idx.extend(range(spec.qpos_start, spec.qpos_start + 7))
        vals.append(torch.cat([pos, _axis_quat(spec.rotation_axis, rot)], dim=-1))
    return idx, torch.cat(vals, dim=-1), valid
