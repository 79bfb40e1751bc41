"""Observables: the declarative sensor pipeline, on batched tensors (the
JAX package's observables.py; robosuite utils/observables.py:4-259).

An Observable is a spec: a sensor tagged with a modality and the stages
corrupter -> filter -> update_every -> delay. Every stage works on a
batch (dim 0 is the scenario). Sampling-rate masking counts policy steps
(`update_every`) instead of wall time, per scenario, and stale values ride
in a cache between steps. The active observables of a modality are
concatenated into "<modality>-state" (robosuite environments/base.py:
429-465).

Noise corrupters draw from an explicit torch.Generator, the one the
caller passes to the step; a noise corrupter with none raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch


def sensor(modality: str):
    """Tag a function with a modality (robosuite observables.py:4-41)."""

    def deco(fn):
        fn.__modality__ = modality
        return fn

    return deco


# corrupter factories (robosuite observables.py:43-155): corrupter(value,
# generator) -> value


def create_deterministic_corrupter(corruption):
    def corrupter(value, generator):
        return value + corruption

    return corrupter


def _need(generator):
    if generator is None:
        raise ValueError("a noise corrupter needs a torch.Generator: pass generator= to reset_batch / step_batch")
    return generator


def create_uniform_noise_corrupter(min_noise, max_noise):
    def corrupter(value, generator):
        g = _need(generator)
        u = torch.rand(value.shape, generator=g, device=g.device, dtype=value.dtype).to(value.device)
        return value + (min_noise + (max_noise - min_noise) * u)

    return corrupter


def create_gaussian_noise_corrupter(mean, std):
    def corrupter(value, generator):
        g = _need(generator)
        n = torch.randn(value.shape, generator=g, device=g.device, dtype=value.dtype).to(value.device)
        return value + mean + std * n

    return corrupter


@dataclasses.dataclass(frozen=True)
class Observable:
    """One observable: a name, a sensor and its optional stages.

    The value refreshes every `update_every` policy steps (robosuite's
    sampling rate) and is seen `delay` steps late; both keep their state
    in the cache."""

    name: str
    sensor: Callable  # (obs_ctx) -> (B, ...) tensor
    corrupter: Optional[Callable] = None  # (value, generator) -> value
    filter: Optional[Callable] = None     # (value) -> value
    delay: int = 0
    update_every: int = 1
    enabled: bool = True
    active: bool = True

    @property
    def modality(self):
        return getattr(self.sensor, "__modality__", "state")


def compute_observables(observables: Sequence[Observable], obs_ctx: Any, generator, t,
                        cache: Optional[Dict[str, Any]] = None):
    """Run the pipeline of every enabled observable at policy step t (B,).
    -> (obs dict, new cache): the active observables and the
    '<modality>-state' vectors (B, n), each the concatenation of its
    modality's active values in the observables' order."""
    obs, new_cache = {}, {}
    by_modality: Dict[str, List[torch.Tensor]] = {}
    for ob in observables:
        if not ob.enabled:
            continue
        val = ob.sensor(obs_ctx)
        if ob.corrupter is not None:
            val = ob.corrupter(val, generator)
        if ob.filter is not None:
            val = ob.filter(val)
        if ob.update_every > 1 and cache is not None and ob.name in cache:
            refresh = (t % ob.update_every) == 0
            val = torch.where(refresh.reshape((-1,) + (1,) * (val.dim() - 1)), val, cache[ob.name])
        if ob.delay > 0 and cache is not None:
            hist = cache.get(ob.name + "__hist")
            if hist is None:  # (delay + 1, B, ...), newest first
                hist = val[None].expand((ob.delay + 1,) + tuple(val.shape))
            hist = torch.cat([val[None], hist[:-1]], dim=0)
            new_cache[ob.name + "__hist"] = hist
            val = hist[-1]
        new_cache[ob.name] = val
        if ob.active:
            obs[ob.name] = val
            by_modality.setdefault(ob.modality, []).append(val.reshape(val.shape[0], -1))
    for modality, vals in by_modality.items():
        obs[f"{modality}-state"] = torch.cat(vals, dim=-1)
    return obs, new_cache
