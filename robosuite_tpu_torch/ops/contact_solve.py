"""K2, the contact-solve kernel: the constrained velocity update of one
substep (smooth solve, elliptic-cone dual QP by APGD, implicit-damping
velocity solve).

Counterpart of robosuite_tpu/ops/pallas_contact.py (make_vel_solver). The
plain version `vel_update_plain` is the JAX package's _vel_update_xla /
_apgd_xla on batched tensors; `vel_update` is the wrapper: plain for CPU
tensors, csrc/contact_solve.cu for CUDA tensors (counted), through
`K2Function` (ops/tangent.py) where an operand carries a derivative.

Operands, rows grouped [normals (K) | t1 (K) | t2 (K) | equality (ne)]:
M (B, nv, nv), JfT (B, nv, ntot), aref (B, ntot), qfrc_smooth, qvel,
damping (B, nv), reg3 (B, ntot), mu, active (B, K), ntot = 3K + ne.
Returns (qvel' (B, nv), f (B, ntot)). K is active's width; the ne rows
past the cone groups are bilateral equality rows (physics/equality.py):
never projected, always active.
"""

from __future__ import annotations

import functools

import torch

from robosuite_tpu_torch.ops import build as _b
from robosuite_tpu_torch.ops import linalg
from robosuite_tpu_torch.ops import tables as _tables
from robosuite_tpu_torch.ops import tangent


def _apgd_plain(JfT, Lm, aref, qacc_smooth, reg3, mu, active, iters, power_iters):
    K = active.shape[-1]
    ones = torch.ones_like(aref[:, 3 * K:])  # the equality rows: active, not projected
    Y = torch.linalg.solve_triangular(Lm, JfT, upper=False)               # (B, nv, 3K)
    diagA = torch.clamp_min(torch.sum(Y * Y, dim=1), 1e-8)
    R = reg3 * diagA
    Lt_q = (Lm.transpose(1, 2) @ qacc_smooth[..., None])[..., 0]
    rhs = aref - (Y.transpose(1, 2) @ Lt_q[..., None])[..., 0]

    def matvec(x):
        return (Y.transpose(1, 2) @ (Y @ x[..., None]))[..., 0] + R * x

    def project(x):
        fn = torch.clamp_min(x[:, :K], 0.0) * active
        t1, t2 = x[:, K:2 * K], x[:, 2 * K:3 * K]
        tn = torch.sqrt(torch.clamp_min(t1 * t1 + t2 * t2, 1e-18))
        scale = torch.clamp_max(mu * fn / torch.clamp_min(tn, 1e-9), 1.0) * active
        return torch.cat([fn, t1 * scale, t2 * scale, x[:, 3 * K:]], dim=1)

    # power-iterate the ACTIVE rows only: inactive light-link rows would
    # inflate the Lipschitz estimate and collapse the step
    rowmask = torch.cat([active, active, active, ones], dim=1)
    v = rowmask + 1e-6
    v = v / torch.clamp_min(torch.linalg.vector_norm(v, dim=1, keepdim=True), 1e-9)
    for _ in range(power_iters):
        w = matvec(v) * rowmask
        v = w / torch.clamp_min(torch.linalg.vector_norm(w, dim=1, keepdim=True), 1e-9)
    L = torch.clamp_min(torch.sum(v * (matvec(v) * rowmask), dim=1, keepdim=True), 1e-6)
    inv_L = 1.0 / (1.1 * L)

    f = torch.zeros_like(aref)
    y = f
    t = torch.ones((), dtype=aref.dtype, device=aref.device)
    for _ in range(iters):
        f_new = project(y - inv_L * (matvec(y) - rhs))
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        y = f_new + ((t - 1.0) / t_new) * (f_new - f)
        f, t = f_new, t_new
    return (Lm @ (Y @ f[..., None]))[..., 0], f


def vel_update_plain(M, JfT, aref, qfrc_smooth, qvel, damping, reg3, mu, active, iters, power_iters, dt):
    """The plain PyTorch velocity update (see module docstring)."""
    Lm = linalg.chol_factor(M)
    qacc_smooth = linalg.chol_solve(Lm, qfrc_smooth - damping * qvel)
    qfrc_con, f = _apgd_plain(JfT, Lm, aref, qacc_smooth, reg3, mu, active, iters, power_iters)
    Mh = M + dt * torch.diag_embed(damping)
    qvel_new = qvel + dt * linalg.solve_spd(Mh, qfrc_smooth + qfrc_con - damping * qvel)
    return qvel_new, f


def check_sizes(nv, K, ne=0):
    """Raise ValueError where nv dofs, K contact slots or ne equality rows
    exceed the kernel's compile-time maxima (csrc/common.cuh RS_MAXV,
    RS_MAXK, RS_MAXE). A launch also checks that its block (two scenarios,
    or one where two do not fit: nv 60 at 96 slots) fits the card's shared
    memory (`_check_block`)."""
    if nv > _tables.MAXV:
        raise ValueError(f"nv={nv} exceeds the kernel's maximum {_tables.MAXV}")
    if K > _tables.MAXK:
        raise ValueError(f"K={K} contact slots exceed the kernel's maximum {_tables.MAXK}")
    if not 0 <= ne <= _tables.MAXE:
        raise ValueError(f"ne={ne} equality rows: the kernel takes 0 to {_tables.MAXE}")


@functools.cache
def _check_block(nv, K, ne):
    """K2's block at (nv, K, ne) within the card's shared memory, else
    ValueError (checked once per size)."""
    _b.check_block(_b.library().rs_contact_solve_smem_bytes(nv, K, ne), "rs_contact_solve",
                   f"one scenario at nv={nv}, K={K}, ne={ne}")


def vel_update(M, JfT, aref, qfrc_smooth, qvel, damping, reg3, mu, active, iters, power_iters, dt):
    """Wrapper: the plain version on CPU tensors, the kernel on CUDA ones;
    on CUDA, operands that carry a derivative go through `K2Function` (the
    kernel's primal, the plain version's tangents)."""
    args = (M, JfT, aref, qfrc_smooth, qvel, damping, reg3, mu, active)
    if M.device.type == "cpu":
        return vel_update_plain(*args, iters, power_iters, dt)
    if tangent.carries_derivative(*args):
        return K2Function.apply(functools.partial(_launch, iters=iters, power_iters=power_iters, dt=dt),
                                functools.partial(vel_update_plain, iters=iters, power_iters=power_iters, dt=dt),
                                vel_update, *args)
    return _launch(*args, iters, power_iters, dt)


class K2Function(tangent.KernelFunction):
    """K2 with its tangent rule (pallas_contact.py _solve_jvp): apply(primal,
    plain, counter, M, JfT, aref, qfrc_smooth, qvel, damping, reg3, mu,
    active) -> (qvel', f)."""


def _launch(M, JfT, aref, qfrc_smooth, qvel, damping, reg3, mu, active, iters, power_iters, dt):
    """One K2 launch (counted) -> (qvel', f)."""
    lib = _b.library()
    B, nv, ntot = JfT.shape
    K = active.shape[-1]
    ne = ntot - 3 * K
    check_sizes(nv, K, ne)
    _check_block(nv, K, ne)
    for t, shape, name in ((M, (B, nv, nv), "M"), (JfT, (B, nv, ntot), "JfT"), (aref, (B, ntot), "aref"),
                           (qfrc_smooth, (B, nv), "qfrc_smooth"), (qvel, (B, nv), "qvel"),
                           (damping, (B, nv), "damping"), (reg3, (B, ntot), "reg3"), (mu, (B, K), "mu"),
                           (active, (B, K), "active")):
        _b.require(t, shape, name)
    qvel_out = torch.empty_like(qvel)
    f = torch.empty_like(aref)
    err = lib.rs_contact_solve(
        *(_b.ptr(t) for t in (M, JfT, aref, qfrc_smooth, qvel, damping, reg3, mu, active, qvel_out, f)),
        B, nv, K, ne, iters, power_iters, float(dt), _b.stream(),
    )
    _b.check(err, "rs_contact_solve")
    vel_update.launches += 1
    return qvel_out, f


vel_update.launches = 0
vel_update.tangent_passes = 0  # K2Function's derivative passes (plain version)
