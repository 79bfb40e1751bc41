"""MPPI: sampling-based MPC over the batched env dynamics (the JAX
package's mpc/mppi.py).

`mppi_step_batch` draws K action sequences per solve around each solve's
nominal plan, rolls the (B, K) grid as ONE flat batch of B*K scenarios
(every planned substep is one kernel launch at full width), and
softmax-weights the returns into each solve's new nominal plan. Rollouts
that went NaN/Inf get zero weight; a solve whose rollouts all diverged
keeps its plan.

The one-scenario entry points (`init_state`, `mppi_step`, `mppi_update`,
`make_solver`) take a state and a plan with no batch dim and run
`mppi_step_batch` at B=1, so the K rollouts of the scenario are one batch
of K through the kernels. Their callables work on batches, as every
callable of the port does: rollout_step(states, actions (K, A)) ->
(states', rewards (K,)) (env.rollout_batch), rollout_return_fn(states,
seqs (K, H, A), discounts) -> (K,) (env.make_plan_return).
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
    # a convex combination of samples in [-1, 1]; the float32 rounding of
    # the weights' sum can carry it an ulp past the bound, so clamp
    new_means = torch.clamp(torch.einsum("bk,bkha->bha", w, seqs), -1.0, 1.0)
    new_means = torch.where(any_finite[:, None, None], new_means, means)
    metrics = dict(
        best_return=masked.max(dim=1).values,
        mean_return=torch.where(finite, returns, torch.zeros_like(returns)).sum(dim=1)
        / torch.clamp_min(finite.sum(dim=1), 1),
        n_masked=(~finite).sum(dim=1),
    )
    return new_means, metrics


def add_batch(tree):
    """A one-scenario state (an EnvState, MPCState or MPPIState with no
    batch dim) as a batch of one."""
    return map_state(lambda x: x[None], tree)


def drop_batch(tree):
    """The only scenario of a batch of one, with no batch dim."""
    return map_state(lambda x: x[0], tree)


@dataclasses.dataclass
class MPPIState:
    """One solve's planner state: the nominal plan mean (H, A) and the
    generator of its noise."""

    mean: torch.Tensor
    generator: Optional[torch.Generator]


def init_state(cfg: MPPIConfig, act_dim: int, generator: Optional[torch.Generator], device="cuda") -> MPPIState:
    """A zero plan on `device` (CUDA unless the caller asks for "cpu")."""
    return MPPIState(mean=torch.zeros(cfg.horizon, act_dim, device=device), generator=generator)


def mppi_step(cfg: MPPIConfig, rollout_step: Callable, env_state, mean, generator: Optional[torch.Generator] = None,
              rollout_return_fn: Callable = None, knots=None):
    """One MPPI update of one scenario's plan mean (H, A) (no receding
    shift) -> (new_mean (H, A), metrics of 0-dim tensors): the K sequences
    roll as one batch of K, through rollout_return_fn where given, else
    through rollout_step one planned step at a time. The standard normals
    come from `generator`, or are given as `knots` (*noise_shape)."""
    if rollout_return_fn is None:
        def rollout_return_fn(states, seqs, discounts):
            rewards = []
            for h in range(seqs.shape[1]):
                states, r = rollout_step(states, seqs[:, h])
                rewards.append(r)
            return (torch.stack(rewards, dim=-1) * discounts).sum(dim=-1)

    new, metrics = mppi_step_batch(cfg, rollout_return_fn, add_batch(env_state), mean[None], generator=generator,
                                   knots=None if knots is None else knots[None])
    return new[0], drop_batch(metrics)


def mppi_update(cfg: MPPIConfig, rollout_step: Callable, env_state, planner: MPPIState, knots=None):
    """One MPPI solve of one scenario -> (action (A,), planner' with the plan
    shifted one step, metrics)."""
    new_mean, metrics = mppi_step(cfg, rollout_step, env_state, planner.mean, generator=planner.generator,
                                  knots=knots)
    shifted = torch.cat([new_mean[1:], torch.zeros_like(new_mean[:1])])
    return new_mean[0], MPPIState(mean=shifted, generator=planner.generator), metrics


def make_solver(cfg: MPPIConfig, env):
    """MPPI bound to an env's policy step (env.rollout_batch) ->
    solve(env_state, planner, knots=None) -> (action, planner', metrics)."""

    def solve(env_state, planner, knots=None):
        return mppi_update(cfg, env.rollout_batch, env_state, planner, knots=knots)

    return solve
