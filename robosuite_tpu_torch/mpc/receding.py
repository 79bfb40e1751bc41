"""Receding-horizon MPC on the port's envs (the JAX package's
mpc/receding.py): `make_solve_batch` solves B scenarios; `make_solve` and
`plan_rollout_step` take one scenario with no batch dim (the batched code
at B=1).

One solve is one control tick of B scenarios:
  1. MPPI warm start (mpc/mppi.py): K sampled action sequences of length H
     per scenario, rolled through a coarse-timestep planning model of the
     full contact physics as one flat batch of B*K scenarios (the env's
     make_plan_return: the emit_aux fused substep), importance-weighted
     into each scenario's nominal plan.
  2. iLQR refinement (mpc/ilqr.py, n_ilqr_iters > 0) of the nominal plan on
     the planning dynamics: forward-difference fx/fu, or with
     ilqr_fd=False forward-mode AD through the dynamics (optionally on a
     coarser `fd_timestep` model), Gauss-Newton cost quadratics from the
     task residual, the sequential Riccati pass (or the associative one,
     parallel_backward) and the line search. With
     relin_every = R > 1 the full linearization runs every R-th tick; in
     between the carried (fx, fu) are shifted one step with the plan
     (real-time iteration). The choice is one host-side decision for the
     whole batch, read from a host mirror of the tick counter.
  3. The first action of each plan is returned; the plans shift by one.

The planning model is the env's model with a coarser timestep, fewer
contact-solver iterations and (optionally) fewer points per pair; the
executed env keeps the full model.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from robosuite_tpu_torch.envs.base import EnvState, map_state
from robosuite_tpu_torch.mpc import ilqr as ilqr_mod
from robosuite_tpu_torch.mpc import mppi as mppi_mod
from robosuite_tpu_torch.mpc.residuals import residual_for
from robosuite_tpu_torch.ops.fk import fk_pose
from robosuite_tpu_torch.physics import engine, kinematics
from robosuite_tpu_torch.physics.state import State
from robosuite_tpu_torch.robots.robot import RobotCtrlState


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    horizon: int = 64                 # H policy steps per solve
    n_samples: int = 32               # MPPI rollouts per solve
    temperature: float = 0.1
    noise_sigma: float = 0.3
    gamma: float = 1.0
    n_knots: int = 8                  # MPPI spline-knot noise (0 = white)
    n_ilqr_iters: int = 1             # 0 = MPPI only
    ilqr_line_search: int = 4
    ilqr_reg: float = 1e-3
    ilqr_fd: bool = True              # forward-difference linearization;
                                      # False: forward-mode AD through the
                                      # dynamics (the kernels' tangent rules)
    parallel_backward: bool = False   # associative-scan Riccati
    plan_timestep: float = 0.01       # planning-model integrator dt
    plan_solver_iters: int = 10       # planning-model APGD iterations
    plan_pair_points: Optional[int] = None  # planning-model points per pair
    fd_solver_iters: int = 6          # APGD / power iterations of the iLQR
    fd_power_iters: int = 4           # dynamics (linearization + line search)
    fd_timestep: Optional[float] = None  # dt of the linearization only
    u_cost: float = 0.05              # control-effort residual weight
    relin_every: int = 1              # full linearization every R-th tick


@dataclasses.dataclass
class MPCState:
    """Per-batch MPC state: plans (B, H, A) and the generator of the MPPI
    noise; with relin_every > 1 also the carried linearization
    fxs (B, H, nx, nx), fus (B, H, nx, A), the tick counter (B,) and its
    host mirror `tick_host` (the ticks are lock-stepped across the batch)."""

    us: torch.Tensor
    generator: Optional[torch.Generator]
    fxs: Optional[torch.Tensor] = None
    fus: Optional[torch.Tensor] = None
    tick: Optional[torch.Tensor] = None
    tick_host: int = 0


def init_state(cfg: MPCConfig, act_dim: int, batch: Optional[int], generator, nx: Optional[int] = None,
               device="cuda") -> MPCState:
    """Zero plans (and, for the RTI carry, a zero linearization) for `batch`
    solves on `device` (CUDA unless the caller asks for "cpu"); batch None:
    one solve's state, with no batch dim (make_solve's)."""
    lead = () if batch is None else (batch,)
    us = torch.zeros(lead + (cfg.horizon, act_dim), device=device)
    if cfg.n_ilqr_iters > 0 and cfg.relin_every > 1:
        if nx is None:
            raise ValueError("relin_every > 1 needs nx (use RecedingMPC.init_state)")
        return MPCState(us=us, generator=generator, fxs=torch.zeros(lead + (cfg.horizon, nx, nx), device=device),
                        fus=torch.zeros(lead + (cfg.horizon, nx, act_dim), device=device),
                        tick=torch.zeros(lead, dtype=torch.int32, device=device))
    return MPCState(us=us, generator=generator)


class RecedingMPC:
    """Binds an env to the batched MPPI + iLQR solve.

    residual: optional planning residual r(env, plan_model, qpos, qvel, u,
    poses) -> (N, m) (mpc/residuals.py); defaults to the env's. Only the
    iLQR reads it: an env with none (ToolHang, TwoArmHandover,
    TwoArmTransport) runs MPPI only (n_ilqr_iters=0), and n_ilqr_iters > 0
    raises NotImplementedError there."""

    def __init__(self, env, cfg: MPCConfig, residual: Optional[Callable] = None):
        self.env = env
        self.cfg = cfg
        self.plan_model = env.model.replace(timestep=cfg.plan_timestep, solver_iters=cfg.plan_solver_iters,
                                            pair_points_cap=cfg.plan_pair_points)
        self.plan_substeps = max(1, int(round(1.0 / (env.control_freq * cfg.plan_timestep))))
        # the iLQR dynamics: the planning model with the cheaper solve
        self.dyn_model = self.plan_model.replace(solver_iters=cfg.fd_solver_iters,
                                                 solver_power_iters=cfg.fd_power_iters)
        self._dyn_fn = env.make_plan_dynamics(self.dyn_model, self.plan_substeps)
        self._lin_fn = None
        if cfg.fd_timestep:
            self.lin_model = self.plan_model.replace(timestep=cfg.fd_timestep, solver_iters=cfg.fd_solver_iters,
                                                     solver_power_iters=cfg.fd_power_iters)
            n_sub = max(1, int(round(1.0 / (env.control_freq * cfg.fd_timestep))))
            self._lin_fn = env.make_plan_dynamics(self.lin_model, n_sub)
        # rollout_return(states, seqs, discounts): the MPPI planning rollouts
        self.plan_rollout_return = env.make_plan_return(self.plan_model, self.plan_substeps)
        # the iLQR alone reads the residual: an MPPI-only solve builds without
        # one, and the iLQR raises where it has none
        self._residual = residual or residual_for(env)
        if self._residual is None and cfg.n_ilqr_iters > 0:
            raise NotImplementedError(f"no planning residual is ported for {type(env).__name__}: the iLQR "
                                      f"(n_ilqr_iters={cfg.n_ilqr_iters}) needs one; pass `residual`")

        # template state for x <-> EnvState: the arm controller's goals are
        # rewritten by set_goals every tick; kp/kd are constants (fixed
        # impedance). The rest of the arm state comes from the template too,
        # as in the JAX package: under OSC's goal interpolation the first
        # planned step ramps from the template's goal, not the scenario's
        # last one (MPPI's rollouts start from the real states)
        self._template = env.reset_batch(1, torch.Generator().manual_seed(0))[0]
        self._nq, self._nv = env.model.nq, env.model.nv
        # (robot, arm, ramp width) of each gripper ramp in x, in robot order
        self._ramps = [(r, arm, cs.gripper_action[arm].shape[-1])
                       for r, cs in enumerate(env._unpack_ctrl(self._template.ctrl)) for arm in sorted(cs.gripper_action)]
        self.nx = self._nq + self._nv + sum(n for _, _, n in self._ramps)
        self._nu = env.action_dim

    def init_state(self, batch: Optional[int], generator: torch.Generator) -> MPCState:
        """MPCState for `batch` solves (with the RTI carry when relin_every >
        1); batch None: one solve's, with no batch dim (make_solve's)."""
        return init_state(self.cfg, self._nu, batch, generator, nx=self.nx, device=self.env.device)

    # -- EnvState <-> iLQR state x = (qpos, qvel, each robot's gripper ramps
    # in robot order; the JAX _grips_of / _to_env_state) ---------------------
    def _to_x(self, s: EnvState):
        cs = self.env._unpack_ctrl(s.ctrl)
        return torch.cat([s.physics.qpos, s.physics.qvel] + [cs[r].gripper_action[arm] for r, arm, _ in self._ramps],
                         dim=-1)

    def _to_env_state(self, x) -> EnvState:
        N, nq, nv = x.shape[0], self._nq, self._nv
        templates = self.env._unpack_ctrl(self._template.ctrl)
        grips, i = [{} for _ in templates], nq + nv
        for r, arm, n in self._ramps:
            grips[r][arm], i = x[:, i:i + n], i + n
        states = [RobotCtrlState(arm=map_state(lambda v: v.expand((N,) + v.shape[1:]), tpl.arm), gripper_action=g)
                  for tpl, g in zip(templates, grips)]
        zeros = torch.zeros(N, dtype=x.dtype, device=x.device)
        return EnvState(physics=State(qpos=x[:, :nq].contiguous(), qvel=x[:, nq:nq + nv].contiguous(), time=zeros),
                        ctrl=self.env._pack_ctrl(states), t=torch.zeros(N, dtype=torch.int32, device=x.device))

    # -- the iLQR problem --------------------------------------------------------
    def _ilqr_dynamics(self, x, u):
        return self._to_x(self._dyn_fn(self._to_env_state(x), u))

    def _ilqr_lin_dynamics(self, x, u):
        return self._to_x(self._lin_fn(self._to_env_state(x), u))

    def _ilqr_residual(self, x, u, t, poses=kinematics.body_poses):
        nq, nv = self._nq, self._nv
        r = self._residual(self.env, self.plan_model, x[:, :nq].contiguous(), x[:, nq:nq + nv], u, poses)
        return torch.cat([r, self.cfg.u_cost * u], dim=-1)

    def _ilqr_cost(self, x, u, t, poses=fk_pose):
        """0.5 ||r||^2 per sample; its value reads the poses from the K4
        kernel (on CUDA), its derivatives from the plain FK."""
        r = self._ilqr_residual(x, u, t, poses=poses)
        return 0.5 * (r * r).sum(dim=-1)

    def _ilqr_terminal(self, x, poses=fk_pose):
        u0 = torch.zeros(x.shape[0], self._nu, dtype=x.dtype, device=x.device)
        t0 = torch.zeros(x.shape[0], dtype=torch.long, device=x.device)
        return 4.0 * self._ilqr_cost(x, u0, t0, poses=poses)

    # -- one scenario (no batch dim), the JAX package's unbatched entry points
    def plan_rollout_step(self, env_state: EnvState, action):
        """(EnvState, action (A,)) -> (EnvState', reward ()) of one
        scenario on the planning model (the env's policy step at B=1)."""
        s = mppi_mod.add_batch(env_state)
        q, qd = s.physics.qpos, s.physics.qvel
        kin, M, bias = engine.forward_products(self.plan_model, q, qd)
        new, r, _ = self.env._rollout_with_products(s, self.env._clip(action[None]), self.plan_model,
                                                    self.plan_substeps, kin, M, bias)
        return mppi_mod.drop_batch(new), r[0]

    def make_solve(self):
        """solve(env_state, mpc_state, knots=None) -> (action (A,),
        mpc_state', metrics): one MPC tick of ONE scenario (no batch dim;
        the state from init_state(None, generator)), the batched solve at
        B=1. `knots` (*mppi.noise_shape) replaces the MPPI draw."""
        solve_batch = self.make_solve_batch()

        def solve(env_state, mpc: MPCState, knots=None):
            a, ms, met = solve_batch(mppi_mod.add_batch(env_state), mppi_mod.add_batch(mpc),
                                     knots=None if knots is None else knots[None])
            return a[0], mppi_mod.drop_batch(ms), {k: v[0] if torch.is_tensor(v) else v for k, v in met.items()}

        return solve

    # -- the solve -----------------------------------------------------------------
    def make_solve_batch(self):
        """solve_batch(env_states, mpc_state, knots=None) -> (actions (B, A),
        mpc_state', metrics): one MPC tick of B scenarios. `knots` (B,
        *mppi.noise_shape) replaces the MPPI draw from the state's
        generator (tests inject the JAX draw)."""
        cfg = self.cfg
        mppi_cfg = mppi_mod.MPPIConfig(horizon=cfg.horizon, n_samples=cfg.n_samples, temperature=cfg.temperature,
                                       noise_sigma=cfg.noise_sigma, gamma=cfg.gamma, n_knots=cfg.n_knots)
        ilqr_cfg = ilqr_mod.ILQRConfig(horizon=cfg.horizon, n_iterations=cfg.n_ilqr_iters, reg_init=cfg.ilqr_reg,
                                       line_search_steps=cfg.ilqr_line_search, use_fd=cfg.ilqr_fd,
                                       parallel_backward=cfg.parallel_backward)
        quads = ilqr_mod.gauss_newton_quadratics(self._ilqr_residual)
        tquads = ilqr_mod.autodiff_terminal_quadratics(lambda x: self._ilqr_terminal(x, poses=kinematics.body_poses))
        lin = self._ilqr_lin_dynamics if self._lin_fn is not None else None

        def refine(env_states, means, frozen):
            """One iLQR refinement; frozen=(fxs, fus) reuses that
            linearization. Non-finite solves keep the MPPI plan, and a
            non-finite linearization is zeroed so it cannot poison the
            carry. -> (us, cost, metrics: ilqr_cost, ilqr_accepted = a
            finite plan, ilqr_improved = the last line search beat the
            plan it started from), fx, fu."""
            sol = ilqr_mod.solve(ilqr_cfg, self._ilqr_dynamics, self._ilqr_cost, self._ilqr_terminal,
                                 self._to_x(env_states), means, quadratics=quads, terminal_quadratics=tquads,
                                 frozen_lin=frozen, lin_dynamics=lin)
            ok = torch.isfinite(sol.us).all(dim=2).all(dim=1)
            us = torch.where(ok[:, None, None], torch.clamp(sol.us, -1.0, 1.0), means)
            fx, fu = (torch.nan_to_num(a, nan=0.0, posinf=0.0, neginf=0.0) for a in sol.lin)
            met = dict(ilqr_cost=sol.cost, ilqr_accepted=ok, ilqr_improved=sol.metrics["accepted"][-1])
            return us, met, fx, fu

        def solve_batch(env_states, mpc: MPCState, knots=None):
            means, metrics = mppi_mod.mppi_step_batch(mppi_cfg, self.plan_rollout_return, env_states, mpc.us,
                                                      generator=mpc.generator, knots=knots)
            carry = {}
            if cfg.n_ilqr_iters > 0 and cfg.relin_every > 1:
                full = mpc.tick_host % cfg.relin_every == 0
                us, met, fx, fu = refine(env_states, means, None if full else (mpc.fxs, mpc.fus))
                carry = dict(fxs=torch.cat([fx[:, 1:], fx[:, -1:]], dim=1),
                             fus=torch.cat([fu[:, 1:], fu[:, -1:]], dim=1),
                             tick=mpc.tick + 1, tick_host=mpc.tick_host + 1)
                metrics = dict(metrics, **met, relinearized=full)
            elif cfg.n_ilqr_iters > 0:
                us, met, _, _ = refine(env_states, means, None)
                metrics = dict(metrics, **met)
            else:
                us = means
            shifted = torch.cat([us[:, 1:], torch.zeros_like(us[:, :1])], dim=1)
            return us[:, 0], MPCState(us=shifted, generator=mpc.generator, **carry), metrics

        return solve_batch
