"""iLQR: iterative LQR trajectory optimization over a batch of solves
(the JAX package's mpc/ilqr.py, with the solve's vmap written out as a
leading batch dim B).

Linearize the dynamics along each nominal trajectory, by forward
differences (use_fd: one dynamics call on a batch of B*H*(1+nx+nu)
scenarios) or by AD through the dynamics (forward mode with jacfwd, else
reverse mode; on the card the kernels' tangent rules, ops/tangent.py),
take the cost quadratics (Gauss-Newton from a residual, or autodiff of the
cost), run the Riccati backward pass (sequential, or the associative
O(log H)-depth pass with parallel_backward), and line-search the
forward rollout (one dynamics call per planned step on a batch of
B*line_search_steps). Non-finite line-search costs are masked to +inf, so
a diverging rollout is never accepted; when every candidate diverges the
iterate is kept and the regularisation grows.

Callables work on batches: dynamics(x (N, nx), u (N, nu)) -> (N, nx),
cost(x, u, t (N,)) -> (N,), terminal_cost(x) -> (N,).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch
from torch import func
from torch.autograd import forward_ad as fwAD

from robosuite_tpu_torch.ops import linalg


@dataclasses.dataclass(frozen=True)
class ILQRConfig:
    horizon: int = 10
    n_iterations: int = 10
    reg_init: float = 1e-6
    reg_max: float = 1e6
    line_search_steps: int = 8
    parallel_backward: bool = False  # associative-scan Riccati over H
    use_jacfwd: bool = True          # use_fd=False: forward mode (nx+nu
                                     # tangents a point), else reverse mode
                                     # (nx cotangents a point)
    use_fd: bool = False             # forward-difference fx/fu
    fd_eps: float = 1e-3


# The most tangent-carrying scenarios one call of the linearized dynamics
# takes: the AD sweep of N = B*H points replicates each point nx+nu times
# (forward mode) or nx times (reverse mode) and runs the copies in chunks
# of at most this many. Each chunk runs the plain substep on dual tensors
# (the kernels' tangent rules), whose operands take twice their primal
# size; Lift's contact Jacobian alone is 198 x 15 floats a scenario, and
# its whole tangent pass peaks near 50 kB a scenario on the card, so a
# chunk of 32768 keeps the pass near 2 GB whatever B and H.
TANGENT_CHUNK = 32768


@dataclasses.dataclass
class ILQRSolution:
    xs: Any        # (B, H+1, nx) optimized state trajectory
    us: Any        # (B, H, nu) optimized controls
    cost: Any      # (B,) final cost
    gains_K: Any   # (B, H, nu, nx) feedback gains of the last backward pass
                   # (about the last iteration's pre-update trajectory)
    gains_k: Any   # (B, H, nu) feedforward (same lag)
    metrics: Any = None  # dict of (n_iterations, B): cost, alpha, accepted
    lin: Any = None      # (fx (B, H, nx, nx), fu (B, H, nx, nu)) used by the
                         # last iteration, for reuse across receding ticks


def _stage_costs(cost, xs, us):
    """(B, H) stage costs of xs (B, H, nx), us (B, H, nu): one cost call
    on the flattened B*H batch."""
    B, H = us.shape[:2]
    t = torch.arange(H, device=us.device).repeat(B)
    return cost(xs.reshape(B * H, -1), us.reshape(B * H, -1), t).reshape(B, H)


def _rollout(dynamics, cost, terminal_cost, x0, us):
    """(xs (B, H+1, nx), total cost (B,)) of the open-loop rollout."""
    xs = [x0]
    for h in range(us.shape[1]):
        xs.append(dynamics(xs[-1], us[:, h]))
    xs = torch.stack(xs, dim=1)
    return xs, _stage_costs(cost, xs[:, :-1], us).sum(dim=1) + terminal_cost(xs[:, -1])


def _mT(a):
    return a.transpose(-1, -2)


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def backward_sequential(fx, fu, cx, cu, cxx, cuu, cux, Vx_T, Vxx_T, reg):
    """The Riccati recursion from the end of the horizon: ->
    (ks (B, H, nu), Ks (B, H, nu, nx), expected improvement (B,)).
    reg: (B,) Levenberg-Marquardt term on Quu."""
    H, nu = cu.shape[1], cu.shape[-1]
    eye = torch.eye(nu, dtype=cuu.dtype, device=cuu.device)
    Vx, Vxx = Vx_T, Vxx_T
    ks, Ks, dv = [None] * H, [None] * H, 0.0
    for h in reversed(range(H)):
        A, Bm = fx[:, h], fu[:, h]
        Qx = cx[:, h] + _mv(_mT(A), Vx)
        Qu = cu[:, h] + _mv(_mT(Bm), Vx)
        Qxx = cxx[:, h] + _mT(A) @ Vxx @ A
        Quu = cuu[:, h] + _mT(Bm) @ Vxx @ Bm + reg[:, None, None] * eye
        Qux = cux[:, h] + _mT(Bm) @ Vxx @ A
        L = linalg.chol_factor(Quu)
        k = -linalg.chol_solve(L, Qu)
        K = -linalg.chol_solve(L, Qux)
        Vx = Qx + _mv(_mT(K) @ Quu, k) + _mv(_mT(K), Qu) + _mv(_mT(Qux), k)
        Vxx = Qxx + _mT(K) @ Quu @ K + _mT(K) @ Qux + _mT(Qux) @ K
        Vxx = 0.5 * (Vxx + _mT(Vxx))
        dv = dv + (-0.5 * (k * _mv(Quu, k)).sum(-1) - (k * Qu).sum(-1))
        ks[h], Ks[h] = k, K
    return torch.stack(ks, dim=1), torch.stack(Ks, dim=1), dv


# The associative (O(log H)-depth) Riccati pass (Sarkka & Garcia-Fernandez,
# "Temporal Parallelization of Dynamic Programming and Linear Quadratic
# Control", 2021; the JAX package's backward_associative). Element
# e_t = (A, b, C, eta, J) parameterizes the conditional value function
# between two times; combining e_i (earlier) with e_j (later) eliminates the
# intermediate state (see _combine). The suffix products
# e_t (x) e_{t+1} (x) ... (x) e_H give the cost-to-go V_t(x) = 0.5 x'S x - eta'x
# with S = J, s = -eta, from which the gains follow for every t at once.
def _lqr_elements(fx, fu, cx, cu, cxx, cuu, cux, Vx_T, Vxx_T, reg):
    """The H+1 elements (B, H+1, ...) of the linearized problem: the cross
    and linear-in-u costs eliminated by completing the square in u; the
    last the terminal cost (no transition)."""
    nu = cu.shape[-1]
    R = cuu + reg[:, None, None, None] * torch.eye(nu, dtype=cuu.dtype, device=cuu.device)
    LR = linalg.chol_factor(R)
    Rinv_P = linalg.chol_solve(LR, cux)                  # (B, H, nu, nx)
    Rinv_r = linalg.chol_solve(LR, cu)                   # (B, H, nu)
    Rinv_BT = linalg.chol_solve(LR, _mT(fu))             # (B, H, nu, nx)
    A = fx - fu @ Rinv_P
    b = -_mv(fu, Rinv_r)
    C = fu @ Rinv_BT
    J = cxx - _mT(cux) @ Rinv_P
    eta = -(cx - _mv(_mT(cux), Rinv_r))
    zA = torch.zeros_like(A[:, :1])
    return (torch.cat([A, zA], 1), torch.cat([b, torch.zeros_like(b[:, :1])], 1), torch.cat([C, zA], 1),
            torch.cat([eta, -Vx_T[:, None]], 1), torch.cat([J, Vxx_T[:, None]], 1))


def _combine(later, earlier):
    """e_i (earlier) combined with e_j (later):
        A_ij = A_j (I + C_i J_j)^-1 A_i
        b_ij = A_j (I + C_i J_j)^-1 (b_i + C_i eta_j) + b_j
        C_ij = A_j (I + C_i J_j)^-1 C_i A_j^T + C_j
      eta_ij = A_i^T (I + J_j C_i)^-1 (eta_j - J_j b_i) + eta_i
        J_ij = A_i^T (I + J_j C_i)^-1 J_j A_i + J_i
    C and J (a cost-to-go Hessian) are symmetric; each combine keeps them
    so, as the sequential pass keeps Vxx: on a stiff linearization (|fx| in
    the thousands) the rounding's asymmetry otherwise grows through the
    scan and moves gains the sequential pass determines."""
    Aj, bj, Cj, etaj, Jj = later
    Ai, bi, Ci, etai, Ji = earlier
    eye = torch.eye(Ai.shape[-1], dtype=Ai.dtype, device=Ai.device)
    M1 = eye + Ci @ Jj
    M2 = eye + Jj @ Ci
    A_ij = Aj @ torch.linalg.solve(M1, Ai)
    b_ij = _mv(Aj, torch.linalg.solve(M1, bi + _mv(Ci, etaj))) + bj
    C_ij = Aj @ torch.linalg.solve(M1, Ci @ _mT(Aj)) + Cj
    eta_ij = _mv(_mT(Ai), torch.linalg.solve(M2, etaj - _mv(Jj, bi))) + etai
    J_ij = _mT(Ai) @ torch.linalg.solve(M2, Jj @ Ai) + Ji
    return A_ij, b_ij, 0.5 * (C_ij + _mT(C_ij)), eta_ij, 0.5 * (J_ij + _mT(J_ij))


def _suffix_scan(elems):
    """S_t = e_t (x) e_{t+1} (x) ... (x) e_T for every t, over dim 1, in
    ceil(log2(T + 1)) rounds of batched combines (Hillis-Steele: at round
    d each S_t with t + d <= T absorbs S_{t+d}); torch has no
    associative_scan."""
    n, d = elems[0].shape[1], 1
    while d < n:
        head = _combine(tuple(e[:, d:] for e in elems), tuple(e[:, :n - d] for e in elems))
        elems = tuple(torch.cat([h, e[:, n - d:]], 1) for h, e in zip(head, elems))
        d *= 2
    return elems


def backward_associative(fx, fu, cx, cu, cxx, cuu, cux, Vx_T, Vxx_T, reg):
    """The O(log H)-depth Riccati pass: -> (ks (B, H, nu), Ks (B, H, nu,
    nx), expected improvement (B,), Ss (B, H+1, nx, nx), ss (B, H+1, nx)),
    Ss[:, t] and ss[:, t] the cost-to-go Hessian and gradient at step t.
    Computed in float64 and returned in the inputs' dtype: each combine
    inverts I + C_i J_j, whose condition grows with the suffix's cost-to-go,
    and on a stiff contact linearization (Lift's, |fx| ~ 300) float32 loses
    gains that the sequential pass keeps (the JAX package runs it in
    float32)."""
    dtype = fx.dtype
    fx, fu, cx, cu, cxx, cuu, cux, Vx_T, Vxx_T, reg = (a.double() for a in (fx, fu, cx, cu, cxx, cuu, cux, Vx_T,
                                                                            Vxx_T, reg))
    _, _, _, etas, Ss = _suffix_scan(_lqr_elements(fx, fu, cx, cu, cxx, cuu, cux, Vx_T, Vxx_T, reg))
    ss = -etas
    S1, s1 = Ss[:, 1:], ss[:, 1:]
    nu = cu.shape[-1]
    Qu = cu + _mv(_mT(fu), s1)
    Quu = cuu + _mT(fu) @ S1 @ fu + reg[:, None, None, None] * torch.eye(nu, dtype=cuu.dtype, device=cuu.device)
    Qux = cux + _mT(fu) @ S1 @ fx
    L = linalg.chol_factor(Quu)
    k = -linalg.chol_solve(L, Qu)
    K = -linalg.chol_solve(L, Qux)
    dv = (-0.5 * (k * _mv(Quu, k)).sum(-1) - (k * Qu).sum(-1)).sum(-1)
    return tuple(a.to(dtype) for a in (k, K, dv, Ss, ss))


def _per_sample(fn):
    """fn on batches -> the same function on one sample (for torch.func)."""
    return lambda *args: fn(*(a[None] for a in args))[0]


def gauss_newton_quadratics(residual: Callable, gn_reg: float = 1e-6):
    """Cost quadratics from a residual r(x, u, t) -> (N, m) with cost
    0.5 ||r||^2 (Gauss-Newton: the Hessian is J_r^T J_r, one forward-mode
    Jacobian of the residual per sample, torch.func.jacfwd under vmap).
    Returns quads(x, u, t) -> (cx, cu, cxx, cuu, cux), batched."""
    jac = func.vmap(func.jacfwd(_per_sample(residual), argnums=(0, 1)))

    def quads(x, u, t):
        r = residual(x, u, t)
        Jx, Ju = jac(x, u, t)
        eye = torch.eye(u.shape[-1], dtype=u.dtype, device=u.device)
        return (_mv(_mT(Jx), r), _mv(_mT(Ju), r), _mT(Jx) @ Jx, _mT(Ju) @ Ju + gn_reg * eye, _mT(Ju) @ Jx)

    return quads


def autodiff_quadratics(cost: Callable):
    """Exact second-order expansion of cost(x, u, t) by torch.func, per
    sample under vmap -> quads(x, u, t) -> (cx, cu, cxx, cuu, cux)."""
    c1 = _per_sample(cost)
    fns = (func.grad(c1, argnums=0), func.grad(c1, argnums=1), func.hessian(c1, argnums=0),
           func.hessian(c1, argnums=1), func.jacrev(func.grad(c1, argnums=1), argnums=0))
    fns = tuple(func.vmap(f) for f in fns)

    def quads(x, u, t):
        return tuple(f(x, u, t) for f in fns)

    return quads


def autodiff_terminal_quadratics(terminal_cost: Callable):
    """(Vx, Vxx) of terminal_cost(x) by torch.func, per sample under vmap."""
    t1 = _per_sample(terminal_cost)
    vx, vxx = func.vmap(func.grad(t1)), func.vmap(func.hessian(t1))

    def tquads(x):
        return vx(x), vxx(x)

    return tquads


def linearize_ad(fn: Callable, xs, us, use_jacfwd: bool = True):
    """(fx (N, nx, nx), fu (N, nx, nu)) of fn(x (N, nx), u (N, nu)) -> (N, nx)
    about (xs, us) by AD through fn (on the card, the kernels' tangent
    rules). Forward mode: each point replicated nx+nu times, copy p
    carrying basis tangent e_p, so the output tangent of copy p is column
    p of [fx | fu]. Reverse mode: each point replicated nx times, copy i's
    output given cotangent e_i, so its input gradients are row i of fx and
    fu. In chunks of at most TANGENT_CHUNK copies, each one call of fn."""
    nx, nu = xs.shape[-1], us.shape[-1]
    P = nx + nu if use_jacfwd else nx
    eye = torch.eye(P, dtype=xs.dtype, device=xs.device)
    n = max(1, TANGENT_CHUNK // P)
    fxs, fus = [], []
    for xc, uc in zip(xs.split(n), us.split(n)):
        m = xc.shape[0]
        X, U = xc.repeat_interleave(P, dim=0), uc.repeat_interleave(P, dim=0)
        E = eye.expand(m, P, P).reshape(m * P, P)
        if use_jacfwd:
            with fwAD.dual_level():
                F = fn(fwAD.make_dual(X, E[:, :nx]), fwAD.make_dual(U, E[:, nx:]))
                cols = fwAD.unpack_dual(F).tangent.reshape(m, P, nx)
            fxs.append(_mT(cols[:, :nx]))
            fus.append(_mT(cols[:, nx:]))
        else:
            X, U = X.detach().requires_grad_(), U.detach().requires_grad_()
            with torch.enable_grad():
                gx, gu = torch.autograd.grad(fn(X, U), (X, U), E)
            fxs.append(gx.reshape(m, nx, nx))
            fus.append(gu.reshape(m, nx, nu))
    return torch.cat(fxs), torch.cat(fus)


def solve(cfg: ILQRConfig, dynamics: Callable, cost: Callable, terminal_cost: Callable, x0, us_init,
          quadratics: Callable = None, terminal_quadratics: Callable = None, frozen_lin=None,
          lin_dynamics: Callable = None) -> ILQRSolution:
    """Run iLQR on B solves: x0 (B, nx), us_init (B, H, nu).

    quadratics: (x, u, t) -> (cx, cu, cxx, cuu, cux), default the autodiff
    expansion of `cost` (which still scores the line search);
    terminal_quadratics: x -> (Vx, Vxx), default autodiff of terminal_cost.
    frozen_lin: (fx (B, H, nx, nx), fu (B, H, nx, nu)) to use instead of
    linearizing (RTI reuse across receding ticks). lin_dynamics: dynamics
    for the linearization only (a coarser model of the same per-step
    transition); the rollout and line search always run `dynamics`."""
    B, H, nu = us_init.shape
    nx = x0.shape[-1]
    lin_src = dynamics if lin_dynamics is None else lin_dynamics
    quadratics = quadratics or autodiff_quadratics(cost)
    terminal_quadratics = terminal_quadratics or autodiff_terminal_quadratics(terminal_cost)
    dt, dev = x0.dtype, x0.device

    def lin_fd(xs, us):
        """Forward differences of lin_src about (xs (N, nx), us (N, nu)):
        the nominal and the nx+nu perturbed evaluations of every point in
        ONE call of N*(1+nx+nu) scenarios."""
        N, P = xs.shape[0], nx + nu
        eye = torch.eye(P, dtype=dt, device=dev)
        X = torch.cat([xs[:, None], xs[:, None] + cfg.fd_eps * eye[None, :, :nx]], dim=1)
        U = torch.cat([us[:, None], us[:, None] + cfg.fd_eps * eye[None, :, nx:]], dim=1)
        F = lin_src(X.reshape(N * (1 + P), nx), U.reshape(N * (1 + P), nu)).reshape(N, 1 + P, nx)
        cols = (F[:, 1:] - F[:, :1]) / cfg.fd_eps                      # (N, P, nx)
        return _mT(cols[:, :nx]), _mT(cols[:, nx:])

    lin_dyn = lin_fd if cfg.use_fd else functools.partial(linearize_ad, lin_src, use_jacfwd=cfg.use_jacfwd)

    def backward(xs, us, reg):
        if frozen_lin is not None:
            fx, fu = frozen_lin
        else:
            fx, fu = lin_dyn(xs[:, :-1].reshape(B * H, nx), us.reshape(B * H, nu))
            fx, fu = fx.reshape(B, H, nx, nx), fu.reshape(B, H, nx, nu)
        t = torch.arange(H, device=dev).repeat(B)
        cq = quadratics(xs[:, :-1].reshape(B * H, nx), us.reshape(B * H, nu), t)
        cq = [c.reshape((B, H) + c.shape[1:]) for c in cq]
        Vx, Vxx = terminal_quadratics(xs[:, -1])
        if cfg.parallel_backward:
            ks, Ks, dv, _, _ = backward_associative(fx, fu, *cq, Vx, Vxx, reg)
        else:
            ks, Ks, dv = backward_sequential(fx, fu, *cq, Vx, Vxx, reg)
        return ks, Ks, dv, (fx, fu)

    def forward(xs, us, ks, Ks, alphas):
        """Closed-loop rollouts for every alpha at once: -> (xs (B, L, H+1,
        nx), us (B, L, H, nu), cost (B, L))."""
        L = alphas.shape[0]

        def rep(a):
            return a[:, None].expand((B, L) + a.shape[1:]).reshape((B * L,) + a.shape[1:])

        xr, ur, kr, Kr = rep(xs), rep(us), rep(ks), rep(Ks)
        al = alphas.repeat(B)[:, None]
        x = xr[:, 0]
        xs2, us2 = [x], []
        for h in range(H):
            u = ur[:, h] + al * kr[:, h] + _mv(Kr[:, h], x - xr[:, h])
            x = dynamics(x, u)
            xs2.append(x)
            us2.append(u)
        xs2, us2 = torch.stack(xs2, dim=1), torch.stack(us2, dim=1)
        total = _stage_costs(cost, xs2[:, :-1], us2).sum(dim=1) + terminal_cost(xs2[:, -1])
        return xs2.reshape(B, L, H + 1, nx), us2.reshape(B, L, H, nu), total.reshape(B, L)

    xs, J = _rollout(dynamics, cost, terminal_cost, x0, us_init)
    us = us_init
    reg = torch.full((B,), cfg.reg_init, dtype=dt, device=dev)
    if cfg.n_iterations == 0:
        ks, Ks, _, lin = backward(xs, us, reg)
        return ILQRSolution(xs=xs, us=us, cost=J, gains_K=Ks, gains_k=ks, metrics=None, lin=lin)

    alphas = 0.5 ** torch.arange(cfg.line_search_steps, dtype=dt, device=dev)
    rows = torch.arange(B, device=dev)
    metrics = {"cost": [], "alpha": [], "accepted": []}
    for _ in range(cfg.n_iterations):
        ks, Ks, _, lin = backward(xs, us, reg)
        xs_c, us_c, J_c = forward(xs, us, ks, Ks, alphas)
        J_c = torch.where(torch.isfinite(J_c), J_c, torch.full_like(J_c, float("inf")))
        best = torch.argmin(J_c, dim=1)
        J_best = J_c[rows, best]
        improved = J_best < J
        xs = torch.where(improved[:, None, None], xs_c[rows, best], xs)
        us = torch.where(improved[:, None, None], us_c[rows, best], us)
        J = torch.where(improved, J_best, J)
        reg = torch.where(improved, torch.clamp_min(reg * 0.5, cfg.reg_init), torch.clamp_max(reg * 10.0, cfg.reg_max))
        metrics["cost"].append(J)
        metrics["alpha"].append(alphas[best])
        metrics["accepted"].append(improved)
    metrics = {k: torch.stack(v) for k, v in metrics.items()}
    return ILQRSolution(xs=xs, us=us, cost=J, gains_K=Ks, gains_k=ks, metrics=metrics, lin=lin)
