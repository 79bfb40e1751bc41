"""K4, the pose-only forward-kinematics kernel: body positions and
quaternions from qpos in one launch.

Counterpart of robosuite_tpu/ops/pallas_fk.py (make_fk_kernel), for any
batch size. `fk_pose` is the wrapper: on CPU tensors it runs the plain
version (`fk_pose_plain`, the poses of kinematics.fk), on CUDA tensors it
launches csrc/fk.cu and counts the launch. The same pose-only walk is the
first stage of the fused substep's aux tail (csrc/substep.cuh aux_tail).
A launch makes one allocation: xpos, then xquat from the next 4-word
boundary (csrc/fk.cu).
"""

from __future__ import annotations

import torch

from robosuite_tpu_torch.ops import build as _b
from robosuite_tpu_torch.ops import tangent
from robosuite_tpu_torch.ops.forward import model_image, model_tables
from robosuite_tpu_torch.physics import kinematics


def fk_pose_plain(model, qpos):
    """(xpos (B, nbody, 3), xquat (B, nbody, 4)) by the plain PyTorch path."""
    kin = kinematics.fk(model, qpos)
    return kin.xpos, kin.xquat


def fk_pose(model, qpos):
    """(xpos (B, nbody, 3), xquat (B, nbody, 4) wxyz) for qpos (B, nq).
    K4 has no tangent rule (nor has the JAX kernel, pallas_fk.py): a qpos
    that carries a derivative raises, on either device, rather than
    leaving the card with a silent zero derivative. Differentiable poses
    come from kinematics.body_poses."""
    if tangent.carries_derivative(qpos):
        raise ValueError("fk_pose: K4 has no tangent rule; differentiate kinematics.body_poses instead")
    if qpos.device.type == "cpu":
        return fk_pose_plain(model, qpos)
    lib = _b.library()
    B, nb = qpos.shape[0], model.nbody
    _b.require(qpos, (B, model.nq), "qpos")
    T, T_host = model_tables(model)
    nxp = B * nb * 3
    at = -(-nxp // 4) * 4
    out = torch.empty(at + B * nb * 4, dtype=torch.float32, device=qpos.device)
    err = lib.rs_fk(T.data_ptr(), T_host.data_ptr(), model_image(model).data_ptr(), qpos.data_ptr(), out.data_ptr(), B,
                    _b.raw_stream(qpos.device))
    _b.check(err, "rs_fk")
    fk_pose.launches += 1
    fk_pose.by_batch[B] = fk_pose.by_batch.get(B, 0) + 1
    return out[:nxp].view(B, nb, 3), out[at:].view(B, nb, 4)


fk_pose.launches = 0
fk_pose.by_batch = {}  # the launches by batch size
