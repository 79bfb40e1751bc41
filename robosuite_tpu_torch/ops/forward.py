"""K1, the forward-products kernel: FK + CRBA + RNEA in one launch.

Counterpart of robosuite_tpu/ops/pallas_forward.py (make_forward_solver).
`forward_products` is the wrapper: on CPU tensors it runs the plain
version (`forward_plain`: kinematics.fk, dynamics.crba, dynamics.rnea_bias),
on CUDA tensors it launches csrc/forward.cu and counts the launch. The
inertial leaves (mass, inertia, gravity, armature) are per-scenario
runtime inputs, as in the JAX kernel; the tree is the packed model table.
"""

from __future__ import annotations

import torch

from robosuite_tpu_torch.ops import build as _b
from robosuite_tpu_torch.ops import tables as _tables
from robosuite_tpu_torch.physics import dynamics, kinematics
from robosuite_tpu_torch.physics.state import KinData


def forward_plain(model, qpos, qvel, mass, inertia, gravity, armature):
    """(KinData, M, bias) by the plain PyTorch path."""
    kin = kinematics.fk(model, qpos)
    M = dynamics.crba(model, kin, mass, inertia, armature)
    bias = dynamics.rnea_bias(model, kin, qvel, mass, inertia, gravity)
    return kin, M, bias


def model_tables(model, arm=None, key=None):
    """(the packed model table on the model's device, its host copy), cached
    on the model (per device and `key`, the fused substep's arm spec)."""
    cache = model.__dict__.setdefault("_kernel_tables", {})
    k = (str(model.device), key)
    if k not in cache:
        host = _tables.pack(model, arm=arm, device="cpu")
        cache[k] = (host.to(model.device), host)
    return cache[k]


def runtime_leaves(model, B):
    """The model's runtime inertial leaves broadcast to a batch of B."""
    return (model.body_mass.expand(B, -1).contiguous(), model.body_inertia.expand(B, -1, 3).contiguous(),
            model.gravity.expand(B, 3).contiguous(), model.dof_armature.expand(B, -1).contiguous())


def forward_products(model, qpos, qvel, mass=None, inertia=None, gravity=None, armature=None):
    """(KinData, M (B, nv, nv), bias (B, nv)) for qpos (B, nq), qvel (B, nv).
    The inertial leaves default to the model's."""
    B = qpos.shape[0]
    if mass is None:
        mass, inertia, gravity, armature = runtime_leaves(model, B)
    if qpos.device.type == "cpu":
        return forward_plain(model, qpos, qvel, mass, inertia, gravity, armature)
    lib = _b.library()
    nq, nv, nb, ng, ns = model.nq, model.nv, model.nbody, model.ngeom, model.nsite
    for t, shape, name in ((qpos, (B, nq), "qpos"), (qvel, (B, nv), "qvel"), (mass, (B, nb), "mass"),
                           (inertia, (B, nb, 3), "inertia"), (gravity, (B, 3), "gravity"),
                           (armature, (B, nv), "armature")):
        _b.require(t, shape, name)
    T, T_host = model_tables(model)
    out = dict(
        xpos=(B, nb, 3), xquat=(B, nb, 4), xmat=(B, nb, 3, 3), geom_xpos=(B, ng, 3), geom_xmat=(B, ng, 3, 3),
        site_xpos=(B, ns, 3), site_xmat=(B, ns, 3, 3), sdof_ang=(B, nv, 3), sdof_lin=(B, nv, 3),
        M=(B, nv, nv), bias=(B, nv), xipos=(B, nb, 3), ximat=(B, nb, 3, 3),
    )
    o = {k: torch.empty(v, dtype=torch.float32, device=qpos.device) for k, v in out.items()}
    err = lib.rs_forward(
        _b.ptr(T), _b.ptr(T_host), *(_b.ptr(t) for t in (qpos, qvel, mass, inertia, gravity, armature)),
        *(_b.ptr(o[k]) for k in out), B, _b.stream(),
    )
    _b.check(err, "rs_forward")
    forward_products.launches += 1
    M, bias = o.pop("M"), o.pop("bias")
    return KinData(**o), M, bias


forward_products.launches = 0
