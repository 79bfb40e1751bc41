"""MPPI: sampling-based MPC over the batched env dynamics (the JAX
package's mpc/mppi.py, batched form).

`mppi_step_batch` draws K action sequences per solve around each solve's
nominal plan, rolls the (B, K) grid as ONE flat batch of B*K scenarios
(every planned substep is one kernel launch at full width), and
softmax-weights the returns into each solve's new nominal plan. Rollouts
that went NaN/Inf get zero weight; a solve whose rollouts all diverged
keeps its plan.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from robosuite_tpu_torch.envs.base import map_state


@dataclasses.dataclass(frozen=True)
class MPPIConfig:
    horizon: int = 8            # policy steps per solve
    n_samples: int = 32         # sampled sequences per solve
    temperature: float = 0.3
    noise_sigma: float = 0.4
    gamma: float = 1.0          # reward discount
    n_knots: int = 0            # 0 = white per-step noise; k > 0 = noise at
                                # k spline knots, linearly interpolated over
                                # the horizon (correlated exploration)


def noise_shape(cfg: MPPIConfig, act_dim: int):
    """Per-solve shape of the standard normals a step draws: (K, k, A) on
    spline knots, else (K, H, A)."""
    if cfg.n_knots and cfg.n_knots < cfg.horizon:
        return (cfg.n_samples, cfg.n_knots, act_dim)
    return (cfg.n_samples, cfg.horizon, act_dim)


def _noise(cfg: MPPIConfig, knots, H):
    """(B, K, H, A) exploration noise from the standard normals `knots`."""
    if cfg.n_knots and cfg.n_knots < H:
        k = cfg.n_knots
        t = torch.linspace(0.0, k - 1.0, H, dtype=knots.dtype, device=knots.device)
        i0 = torch.clamp(torch.floor(t).long(), 0, k - 2)
        frac = (t - i0.to(t.dtype))[None, None, :, None]
        return cfg.noise_sigma * (knots[:, :, i0, :] * (1.0 - frac) + knots[:, :, i0 + 1, :] * frac)
    return cfg.noise_sigma * knots


def mppi_step_batch(cfg: MPPIConfig, rollout_return_fn: Callable, env_states, means,
                    generator: Optional[torch.Generator] = None, knots=None):
    """One MPPI update of B solves. rollout_return_fn(states, seqs,
    discounts) -> (N,) returns of N sequences (N, H, A) from N states
    (env.make_plan_return). env_states and means (B, H, A) carry a leading
    B. The standard normals come from `generator`, or are given as `knots`
    (B, *noise_shape). Returns (new_means (B, H, A), metrics)."""
    B, H, A = means.shape
    K = cfg.n_samples
    if knots is None:
        knots = torch.randn((B,) + noise_shape(cfg, A), generator=generator, device=generator.device,
                            dtype=means.dtype).to(means.device)
    seqs = torch.clamp(means[:, None] + _noise(cfg, knots, H), -1.0, 1.0)  # (B, K, H, A)
    discounts = cfg.gamma ** torch.arange(H, dtype=means.dtype, device=means.device)

    flat_states = map_state(lambda x: x.repeat_interleave(K, dim=0), env_states)
    returns = rollout_return_fn(flat_states, seqs.reshape(B * K, H, A), discounts).reshape(B, K)

    finite = torch.isfinite(returns)
    masked = torch.where(finite, returns, torch.full_like(returns, -float("inf")))
    any_finite = finite.any(dim=1)
    w = torch.softmax(masked / cfg.temperature, dim=1)
    w = torch.where(any_finite[:, None], w, torch.zeros_like(w))
    new_means = torch.einsum("bk,bkha->bha", w, seqs)
    new_means = torch.where(any_finite[:, None, None], new_means, means)
    metrics = dict(
        best_return=masked.max(dim=1).values,
        mean_return=torch.where(finite, returns, torch.zeros_like(returns)).sum(dim=1)
        / torch.clamp_min(finite.sum(dim=1), 1),
        n_masked=(~finite).sum(dim=1),
    )
    return new_means, metrics
