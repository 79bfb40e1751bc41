"""The kernels' tangent rules: a torch.autograd.Function whose primal is a
kernel launch and whose derivatives come from the kernel's plain version
(the JAX package's custom_jvp boundaries: pallas_forward.py _fp_jvp,
pallas_contact.py _solve_jvp, pallas_substep.py _sub_jvp, where primal
calls launch the Pallas kernel and tangents ride the XLA path).

`KernelFunction.apply(primal, plain, counter, *tensors)` returns primal's
outputs (a tuple of tensors, computed on the card by the kernel) and
carries derivatives for them:

- forward mode (`jvp`, for torch.autograd.forward_ad duals and
  torch.func.jvp): the plain version runs on dual tensors at the same
  primals, with forward gradients enabled again at the current level (a
  nested torch.func.jvp inside a Function's jvp would need a second
  forward-AD level, which torch does not support);
- reverse mode (`backward`): one torch.autograd.grad through the plain
  version at the saved primals.

The plain version runs only for derivatives: the primal outputs are
always the kernel's. `counter` (the wrapper) counts the derivative passes
in `counter.tangent_passes`. The wrappers take this path on CUDA when an
operand carries a derivative (`carries_derivative`), and launch directly
otherwise.
"""

from __future__ import annotations

import torch
from torch.autograd import forward_ad as fwAD


def carries_derivative(*tensors) -> bool:
    """True where any tensor carries a forward-mode tangent (at the current
    dual level, or as a torch.func transform's wrapper) or takes part in a
    reverse-mode graph."""
    level = fwAD._current_level
    grad = torch.is_grad_enabled()
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            continue
        if (grad and t.requires_grad) or torch._C._functorch.is_functorch_wrapped_tensor(t):
            return True
        if level >= 0 and fwAD.unpack_dual(t).tangent is not None:
            return True
    return False


def _primal_of(t):
    return fwAD.unpack_dual(t).primal if fwAD._current_level >= 0 else t


class KernelFunction(torch.autograd.Function):
    """primal(*tensors) -> tuple of outputs (the kernel launch);
    plain(*tensors) -> the same outputs by plain PyTorch (the tangent rule)."""

    @staticmethod
    def forward(primal, plain, counter, *args):
        # an output that is a view (K1's outputs share one allocation) gets
        # its own storage: a view's tangent must share its base's layout
        return tuple(o.clone() if o._base is not None else o for o in primal(*args))

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.plain, ctx.counter, *args = inputs
        ctx.save_for_forward(*args)
        ctx.save_for_backward(*args)

    @staticmethod
    def jvp(ctx, _primal, _plain, _counter, *tangents):
        ctx.counter.tangent_passes += 1
        args = [_primal_of(a) for a in ctx.saved_tensors]
        with fwAD._set_fwd_grad_enabled(True):
            # a tangent may come as zeros where the operand carries none; a
            # dual needs storage of its own, not a batch stride of 0
            duals = [a if t is None else fwAD.make_dual(a if 0 not in a.stride() else a.contiguous(), t)
                     for a, t in zip(args, tangents)]
            outs = ctx.plain(*duals)
            tans = [fwAD.unpack_dual(o).tangent for o in outs]
        return tuple(torch.zeros_like(fwAD.unpack_dual(o).primal) if t is None else t.clone()
                     for o, t in zip(outs, tans))

    @staticmethod
    def backward(ctx, *grads):
        ctx.counter.tangent_passes += 1
        need = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            args = [a.detach().requires_grad_(n) for a, n in zip(ctx.saved_tensors, need)]
            outs = ctx.plain(*args)
            used = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
            wrt = [a for a, n in zip(args, need) if n]
            gs = iter(torch.autograd.grad([o for o, _ in used], wrt, [g for _, g in used], allow_unused=True)
                      if used and wrt else [None] * len(wrt))
        return (None, None, None) + tuple(next(gs) if n else None for n in need)
