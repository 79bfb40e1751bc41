"""Rotation and pose math on batched tensors (the JAX package's
utils/transforms.py; robosuite utils/transform_utils.py).

Public-API quaternions are xyzw (robosuite transform_utils convention);
the `_wxyz` helpers are MuJoCo-convention and used by the physics. Euler
angles are the static-frame 'sxyz' convention. All functions broadcast
over leading batch dimensions (the batch on dim 0).
"""

from __future__ import annotations

import torch

EPS = 1e-8


def convert_quat(q, to="xyzw"):
    """wxyz -> xyzw (to="xyzw") or xyzw -> wxyz (to="wxyz")."""
    if to == "xyzw":
        return q[..., [1, 2, 3, 0]]
    if to == "wxyz":
        return q[..., [3, 0, 1, 2]]
    raise ValueError("convert_quat: `to` must be 'xyzw' or 'wxyz'")


def unit_vector(data, dim=-1):
    return data / torch.clamp_min(torch.linalg.vector_norm(data, dim=dim, keepdim=True), EPS)


def quat_multiply(q1, q0):
    """Hamilton product q1 * q0, xyzw (robosuite transform_utils.py:67-95)."""
    x0, y0, z0, w0 = q0.unbind(-1)
    x1, y1, z1, w1 = q1.unbind(-1)
    return torch.stack(
        [
            x1 * w0 + y1 * z0 - z1 * y0 + w1 * x0,
            -x1 * z0 + y1 * w0 + z1 * x0 + w1 * y0,
            x1 * y0 - y1 * x0 + z1 * w0 + w1 * z0,
            -x1 * x0 - y1 * y0 - z1 * z0 + w1 * w0,
        ],
        dim=-1,
    )


def quat_conjugate(q):
    """Conjugate, xyzw."""
    return q * torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype, device=q.device)


def quat_inverse(q):
    """Inverse, xyzw."""
    return quat_conjugate(q) / torch.sum(q * q, dim=-1, keepdim=True)


def quat_distance(q1, q0):
    """q1 * q0^-1, xyzw."""
    return quat_multiply(q1, quat_inverse(q0))


def quat_slerp(quat0, quat1, fraction, shortestpath=True):
    """Spherical linear interpolation, xyzw (robosuite transform_utils.py:
    151-203), branch-free: the linear blend where the two are within EPS of
    each other. `fraction` is a number or a tensor broadcasting against the
    quaternions' batch."""
    q0, q1 = unit_vector(quat0), unit_vector(quat1)
    d = torch.sum(q0 * q1, dim=-1)
    if shortestpath:
        flip = d < 0.0
        d = torch.where(flip, -d, d)
        q1 = torch.where(flip[..., None], -q1, q1)
    d = torch.clamp(d, -1.0, 1.0)
    angle = torch.arccos(d)
    isin = 1.0 / torch.clamp_min(torch.sin(angle), EPS)
    f = torch.as_tensor(fraction, dtype=q0.dtype, device=q0.device)
    out = (torch.sin((1.0 - f) * angle) * isin)[..., None] * q0 + (torch.sin(f * angle) * isin)[..., None] * q1
    lerp = (1.0 - f)[..., None] * q0 + f[..., None] * q1 if f.dim() else (1.0 - f) * q0 + f * q1
    return torch.where((torch.abs(d - 1.0) < EPS)[..., None], lerp, out)


def quat2mat(quaternion):
    """xyzw quaternion -> 3x3 rotation matrix."""
    x, y, z, w = unit_vector(quaternion).unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def mat2quat(rmat):
    """3x3 rotation matrix -> xyzw quaternion (Shepperd's method, w >= 0)."""
    m = rmat
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1)
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4, 4) wxyz rows
    q = torch.gather(cands, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    q = unit_vector(q)
    q = torch.where(q[..., 0:1] < 0, -q, q)
    return convert_quat(q, to="xyzw")


def euler2mat(euler):
    """(r, p, y) euler angles -> rotation matrix in robosuite's formulation
    (transform_utils.py:358-391: R = Rz(y) Ry(p) Rx(r))."""
    ai, aj, ak = -euler[..., 2], -euler[..., 1], -euler[..., 0]
    si, sj, sk = torch.sin(ai), torch.sin(aj), torch.sin(ak)
    ci, cj, ck = torch.cos(ai), torch.cos(aj), torch.cos(ak)
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk
    m = torch.stack(
        [
            cj * ci, cj * si, -sj,
            sj * cs - sc, sj * ss + cc, cj * sk,
            sj * cc + ss, sj * sc - cs, cj * ck,
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def mat2euler(rmat):
    """Rotation matrix -> 'sxyz' euler angles (robosuite transform_utils.py:
    394-442; like robosuite's, not the inverse of euler2mat above)."""
    m = rmat
    cy = torch.sqrt(m[..., 0, 0] ** 2 + m[..., 1, 0] ** 2)
    cond = cy > EPS
    ax = torch.where(cond, torch.atan2(m[..., 2, 1], m[..., 2, 2]), torch.atan2(-m[..., 1, 2], m[..., 1, 1]))
    ay = torch.atan2(-m[..., 2, 0], cy)
    az = torch.where(cond, torch.atan2(m[..., 1, 0], m[..., 0, 0]), torch.zeros_like(ax))
    return torch.stack([ax, ay, az], dim=-1)


def axisangle2quat(vec):
    """Exponential coordinates -> xyzw quaternion (Taylor branch near 0)."""
    sq = torch.sum(vec * vec, dim=-1, keepdim=True)
    small = sq < 1e-12
    angle = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    k = torch.where(small, 0.5 - sq / 48.0, torch.sin(angle / 2.0) / angle)
    w = torch.where(small, 1.0 - sq / 8.0, torch.cos(angle / 2.0))
    return torch.cat([vec * k, w], dim=-1)


def quat2axisangle(quat):
    """xyzw quaternion -> exponential coordinates (robosuite
    transform_utils.py:490-514); zero where the angle is."""
    w = torch.clamp(quat[..., 3:4], -1.0, 1.0)
    den = torch.sqrt(torch.clamp_min(1.0 - w * w, 0.0))
    out = quat[..., :3] * (2.0 * torch.arccos(w)) / torch.clamp_min(den, EPS)
    return torch.where(den < EPS, torch.zeros_like(out), out)


def make_pose(translation, rotation):
    """(pos (..., 3), rot (..., 3, 3)) -> homogeneous (..., 4, 4)."""
    batch = torch.broadcast_shapes(translation.shape[:-1], rotation.shape[:-2])
    top = torch.cat([rotation.expand(batch + (3, 3)), translation.expand(batch + (3,))[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rotation.dtype, device=rotation.device).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def pose2mat(pose):
    """(pos, xyzw quat) -> homogeneous 4x4."""
    pos, quat = pose
    return make_pose(pos, quat2mat(quat))


def mat2pose(hmat):
    """Homogeneous 4x4 -> (pos, xyzw quat)."""
    return hmat[..., :3, 3], mat2quat(hmat[..., :3, :3])


def pose_inv(pose):
    """The inverse of a homogeneous pose."""
    rot_t = pose[..., :3, :3].transpose(-1, -2)
    return make_pose(-(rot_t @ pose[..., :3, 3:4])[..., 0], rot_t)


def pose_in_A_to_pose_in_B(pose_A, pose_A_in_B):
    """A pose in frame A, given frame A's pose in B, in frame B."""
    return pose_A_in_B @ pose_A


def quat_mul_wxyz(u, v):
    w0, x0, y0, z0 = u.unbind(-1)
    w1, x1, y1, z1 = v.unbind(-1)
    return torch.stack(
        [
            w0 * w1 - x0 * x1 - y0 * y1 - z0 * z1,
            w0 * x1 + x0 * w1 + y0 * z1 - z0 * y1,
            w0 * y1 - x0 * z1 + y0 * w1 + z0 * x1,
            w0 * z1 + x0 * y1 - y0 * x1 + z0 * w1,
        ],
        dim=-1,
    )


def quat_rot_wxyz(q, v):
    """Rotate vector v by wxyz quaternion q."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    u, v = torch.broadcast_tensors(u, v)
    uv = torch.linalg.cross(u, v)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv))


def quat2mat_wxyz(q):
    return quat2mat(convert_quat(q, to="xyzw"))


def mat2quat_wxyz(m):
    return convert_quat(mat2quat(m), to="wxyz")


def quat_conj_wxyz(q):
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def axisangle2quat_wxyz(vec):
    return convert_quat(axisangle2quat(vec), to="wxyz")


def quat_integrate_wxyz(q, omega, dt):
    """q' = q * exp(0.5 * omega * dt), omega in the body-local frame
    (MuJoCo mju_quatIntegrate), renormalised."""
    v = omega * dt
    sq = torch.sum(v * v, dim=-1, keepdim=True)
    small = sq < 1e-12
    angle = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    k = torch.where(small, 0.5 - sq / 48.0, torch.sin(angle / 2.0) / angle)
    w = torch.where(small, 1.0 - sq / 8.0, torch.cos(angle / 2.0))
    return unit_vector(quat_mul_wxyz(q, torch.cat([w, v * k], dim=-1)))


def orientation_error(desired, current):
    """0.5 * sum_i cross(current[:, i], desired[:, i]) (robosuite
    control_utils.py:85-111)."""
    return 0.5 * sum(
        torch.linalg.cross(current[..., :, i], desired[..., :, i]) for i in range(3)
    )


def skew(v):
    """3-vector -> skew-symmetric matrix, [v]x u = v x u."""
    z = torch.zeros_like(v[..., 0])
    rows = torch.stack([z, -v[..., 2], v[..., 1], v[..., 2], z, -v[..., 0], -v[..., 1], v[..., 0], z], dim=-1)
    return rows.reshape(v.shape[:-1] + (3, 3))


def rotation_matrix(angle, direction):
    """Rotation by `angle` about the axis `direction` (robosuite
    transform_utils.py:663-720 with no point), batched over both."""
    d = unit_vector(torch.as_tensor(direction, dtype=torch.float32))
    angle = torch.as_tensor(angle, dtype=d.dtype, device=d.device)[..., None, None]
    eye = torch.eye(3, dtype=d.dtype, device=d.device)
    return eye * torch.cos(angle) + d[..., :, None] * d[..., None, :] * (1.0 - torch.cos(angle)) \
        + skew(d) * torch.sin(angle)
