"""K1, the forward-products kernel: FK + CRBA + RNEA in one launch.

Counterpart of robosuite_tpu/ops/pallas_forward.py (make_forward_solver).
`forward_products` is the wrapper: on CPU tensors it runs the plain
version (`forward_plain`: kinematics.fk, dynamics.crba, dynamics.rnea_bias),
on CUDA tensors it launches csrc/forward.cu and counts the launch. The
inertial leaves (mass, inertia, gravity, armature) are per-scenario
runtime inputs, as in the JAX kernel; the tree is the packed model table.
A launch makes one allocation, which holds the 13 outputs (`OUTPUTS`, at
the offsets `out_views` gives, as the C launcher derives them); a leaf
may have batch stride 0, so the model's own leaves go in as expanded views.
Operands that carry a derivative go through `K1Function` (ops/tangent.py:
the launch's primal, `forward_plain`'s tangents).
"""

from __future__ import annotations

import functools

import torch

from robosuite_tpu_torch.ops import build as _b
from robosuite_tpu_torch.ops import tables as _tables
from robosuite_tpu_torch.ops import tangent
from robosuite_tpu_torch.physics import dynamics, kinematics
from robosuite_tpu_torch.physics.state import KinData

# the outputs in the order of the allocation (csrc/forward.cuh k1_sizes)
OUTPUTS = ("xpos", "xquat", "xmat", "geom_xpos", "geom_xmat", "site_xpos", "site_xmat", "sdof_ang", "sdof_lin", "M",
           "bias", "xipos", "ximat")


def forward_plain(model, qpos, qvel, mass, inertia, gravity, armature):
    """(KinData, M, bias) by the plain PyTorch path."""
    kin = kinematics.fk(model, qpos)
    M = dynamics.crba(model, kin, mass, inertia, armature)
    bias = dynamics.rnea_bias(model, kin, qvel, mass, inertia, gravity)
    return kin, M, bias


def model_tables(model, arm=None, key=None):
    """(the packed model table on the model's device, its host copy), cached
    on the model (per device and `key`). With `arm` (the fused substep's
    arm spec) the table has the contact part; without (K1, K4) it has not,
    so K1 and K4 take a world whatever its pairs."""
    cache = model.__dict__.setdefault("_kernel_tables", {})
    k = (str(model.device), key)
    if k not in cache:
        host = _tables.pack(model, arm=arm, device="cpu")
        cache[k] = (host.to(model.device), host)
    return cache[k]


def model_image(model):
    """The compact image of the model rows K1 and K4 stage in shared memory
    (csrc/forward.cuh carve_tab, built by the library from the packed
    table), on the model's device, cached on the model."""
    cache = model.__dict__.setdefault("_kernel_tables", {})
    k = (str(model.device), "image")
    if k not in cache:
        lib, T_host = _b.library(), model_tables(model)[1]
        img = torch.empty(lib.rs_forward_tab(T_host.data_ptr(), None), dtype=torch.float32)
        lib.rs_forward_tab(T_host.data_ptr(), img.data_ptr())
        cache[k] = img.to(model.device)
    return cache[k]


def runtime_leaves(model, B):
    """The model's runtime inertial leaves broadcast to a batch of B, each a
    contiguous copy (the fused substep's operands)."""
    return tuple(t.contiguous() for t in model_leaves(model, B))


def model_leaves(model, B):
    """The model's runtime inertial leaves as (B, ...) views of batch stride 0."""
    return (model.body_mass.expand(B, -1), model.body_inertia.expand(B, -1, 3), model.gravity.expand(B, 3),
            model.dof_armature.expand(B, -1))


def out_shapes(model, B):
    """{output: shape} of a launch on B scenarios, in allocation order."""
    nb, ng, ns, nv = model.nbody, model.ngeom, model.nsite, model.nv
    return dict(zip(OUTPUTS, ((B, nb, 3), (B, nb, 4), (B, nb, 3, 3), (B, ng, 3), (B, ng, 3, 3), (B, ns, 3),
                              (B, ns, 3, 3), (B, nv, 3), (B, nv, 3), (B, nv, nv), (B, nv), (B, nb, 3),
                              (B, nb, 3, 3))))


def out_views(shapes):
    """[(output, first word, words, shape)] in the one allocation (each
    output 4-word aligned, csrc/forward.cuh k1_offset), and its words."""
    views, o = [], 0
    for name, shape in shapes.items():
        n = 1
        for d in shape:
            n *= d
        views.append((name, o, n, shape))
        o += -(-n // 4) * 4
    return views, o


def _chunks(views, total):
    """(the allocation's chunk sizes for one split_with_sizes: each output's
    words, then its padding; [(output, its chunk's index, shape)])."""
    sizes, which, o = [], [], 0
    for name, off, n, shape in views:
        if off > o:
            sizes.append(off - o)
        which.append((name, len(sizes), shape))
        sizes.append(n)
        o = off + n
    if total > o:
        sizes.append(total - o)
    return sizes, which


def _row_strides(shape):
    """The strides of a contiguous row of a (B, *row) leaf."""
    st, n = [], 1
    for d in reversed(shape[1:]):
        st.append(n)
        n *= d
    return tuple(reversed(st)), n


class _Launch:
    """What a model's launches reuse: the table's pointers and, per batch
    size, the output views and the leaves' shapes and row strides, and the
    model's leaves as stride-0 views."""

    def __init__(self, model, device):
        T, T_host = model_tables(model)
        _b.check_block(_b.library().rs_forward_smem_bytes(T_host.data_ptr()), "rs_forward",
                       f"a world of {model.nbody} bodies at nv {model.nv}")
        img = model_image(model)
        self.device, self.T, self.T_host, self.img = device, T.data_ptr(), T_host.data_ptr(), img.data_ptr()
        self.tables = (T, T_host, img)  # kept alive with the pointers
        self.model, self.per_B = model, {}

    def layout(self, B):
        if B not in self.per_B:
            m = self.model
            leaf_shapes = ((B, m.nbody), (B, m.nbody, 3), (B, 3), (B, m.nv))
            leaves = tuple((name, shape, *_row_strides(shape))
                           for name, shape in zip(("mass", "inertia", "gravity", "armature"), leaf_shapes))
            views, total = out_views(out_shapes(m, B))
            self.per_B[B] = (*_chunks(views, total), total, leaves, model_leaves(m, B))
        return self.per_B[B]


def _leaf_stride(t, name, shape, row, n):
    """A leaf operand: float32 on CUDA of `shape`, its rows contiguous
    (strides `row`), batch stride n or 0. -> the batch stride."""
    s = t.stride()
    if not (t.is_cuda and t.dtype == torch.float32 and t.shape == shape and s[1:] == row and s[0] in (0, n)):
        raise ValueError(f"{name}: need a float32 CUDA tensor of shape {tuple(shape)} with contiguous rows and batch "
                         f"stride {n} or 0, got {t.dtype} {tuple(t.shape)} strides {s} on {t.device}")
    return s[0]


def forward_products(model, qpos, qvel, mass=None, inertia=None, gravity=None, armature=None):
    """(KinData, M (B, nv, nv), bias (B, nv)) for qpos (B, nq), qvel (B, nv).
    The inertial leaves default to the model's. On CUDA, operands that
    carry a derivative go through `K1Function` (the kernel's primal, the
    plain version's tangents); others launch directly."""
    B = qpos.shape[0]
    if qpos.device.type == "cpu":
        if mass is None:
            mass, inertia, gravity, armature = model_leaves(model, B)
        return forward_plain(model, qpos, qvel, mass, inertia, gravity, armature)
    if tangent.carries_derivative(qpos, qvel, mass, inertia, gravity, armature):
        leaves = model_leaves(model, B) if mass is None else (mass, inertia, gravity, armature)
        return _unpack(K1Function.apply(functools.partial(_launch, model), functools.partial(plain_outputs, model),
                                        forward_products, qpos, qvel, *leaves))
    return _unpack(_launch(model, qpos, qvel, mass, inertia, gravity, armature))


def plain_outputs(model, qpos, qvel, mass, inertia, gravity, armature):
    """forward_plain's results as the tuple of OUTPUTS (K1Function's tangent rule)."""
    kin, M, bias = forward_plain(model, qpos, qvel, mass, inertia, gravity, armature)
    return tuple(M if n == "M" else bias if n == "bias" else getattr(kin, n) for n in OUTPUTS)


def _unpack(outs):
    o = dict(zip(OUTPUTS, outs))
    M, bias = o.pop("M"), o.pop("bias")
    return KinData(**o), M, bias


class K1Function(tangent.KernelFunction):
    """K1 with its tangent rule (pallas_forward.py _fp_jvp): apply(primal,
    plain, counter, qpos, qvel, mass, inertia, gravity, armature) -> the
    OUTPUTS; primal the launch, plain `plain_outputs`."""


def _launch(model, qpos, qvel, mass=None, inertia=None, gravity=None, armature=None):
    """One K1 launch (counted) -> the OUTPUTS, views of one allocation."""
    B = qpos.shape[0]
    lib = _b.library()
    ctx = model.__dict__.get("_k1_launch")
    if ctx is None or ctx.device != qpos.device:
        ctx = model.__dict__["_k1_launch"] = _Launch(model, qpos.device)
    sizes, which, total, leaf_specs, own = ctx.layout(B)
    leaves = own if mass is None else (mass, inertia, gravity, armature)
    _b.require(qpos, (B, model.nq), "qpos")
    _b.require(qvel, (B, model.nv), "qvel")
    args = []
    for t, spec in zip(leaves, leaf_specs):
        args += (t.data_ptr(), _leaf_stride(t, *spec))
    out = torch.empty(total, dtype=torch.float32, device=qpos.device)
    err = lib.rs_forward(ctx.T, ctx.T_host, ctx.img, qpos.data_ptr(), qvel.data_ptr(), *args, out.data_ptr(), B,
                         _b.raw_stream(qpos.device))
    _b.check(err, "rs_forward")
    forward_products.launches += 1
    forward_products.by_batch[B] = forward_products.by_batch.get(B, 0) + 1
    parts = out.split_with_sizes(sizes)
    o = {name: parts[i].view(shape) for name, i, shape in which}
    return tuple(o[n] for n in OUTPUTS)


forward_products.launches = 0
forward_products.by_batch = {}  # the launches by batch size
forward_products.tangent_passes = 0  # K1Function's derivative passes (plain version)
