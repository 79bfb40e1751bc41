"""K4, the pose-only forward-kinematics kernel: body positions and
quaternions from qpos in one launch.

Counterpart of robosuite_tpu/ops/pallas_fk.py (make_fk_kernel), for any
batch size. `fk_pose` is the wrapper: on CPU tensors it runs the plain
version (`fk_pose_plain`, the poses of kinematics.fk), on CUDA tensors it
launches csrc/fk.cu and counts the launch. The same pose-only walk is the
first stage of the fused substep's aux tail (csrc/substep.cuh aux_tail).
"""

from __future__ import annotations

import torch

from robosuite_tpu_torch.ops import build as _b
from robosuite_tpu_torch.ops.forward import model_tables
from robosuite_tpu_torch.physics import kinematics


def fk_pose_plain(model, qpos):
    """(xpos (B, nbody, 3), xquat (B, nbody, 4)) by the plain PyTorch path."""
    kin = kinematics.fk(model, qpos)
    return kin.xpos, kin.xquat


def fk_pose(model, qpos):
    """(xpos (B, nbody, 3), xquat (B, nbody, 4) wxyz) for qpos (B, nq)."""
    if qpos.device.type == "cpu":
        return fk_pose_plain(model, qpos)
    lib = _b.library()
    B = qpos.shape[0]
    _b.require(qpos, (B, model.nq), "qpos")
    T = model_tables(model)[0]
    xpos = torch.empty(B, model.nbody, 3, dtype=torch.float32, device=qpos.device)
    xquat = torch.empty(B, model.nbody, 4, dtype=torch.float32, device=qpos.device)
    err = lib.rs_fk(_b.ptr(T), _b.ptr(qpos), _b.ptr(xpos), _b.ptr(xquat), B, _b.stream())
    _b.check(err, "rs_fk")
    fk_pose.launches += 1
    return xpos, xquat


fk_pose.launches = 0
