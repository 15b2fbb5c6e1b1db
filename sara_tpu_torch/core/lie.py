"""SO(3) / SE(3) / Sim(3): quaternions, angle-axis exp/log, yaw-pitch-roll,
RQ factorization.

Twin of ``sara_tpu/core/lie.py``. All functions are pure and broadcast over
leading batch dimensions; small-angle cases use Taylor branches selected by
``torch.where``, so they are safe under ``torch.func`` transforms.
"""

from __future__ import annotations

import torch

from sara_tpu_torch.ops.smallmat import cross

_EPS = 1e-8


def _eye(n: int, like: torch.Tensor, batch=()) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device).expand(
        *batch, n, n)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., i, j) x (..., j) -> (..., i)."""
    return (M @ v[..., None])[..., 0]


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z) convention.
# ---------------------------------------------------------------------------

def quat_identity(dtype=torch.float32) -> torch.Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by unit quaternion(s) q."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> 3x3 rotation matrix (batched)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix -> unit quaternion (w, x, y, z), w >= 0,
    branch-free: the candidate with the largest leading term wins."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10,
                      m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22,
                      m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21,
                      1.0 + m22 - m00 - m11], dim=-1)
    lead = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                        1.0 + m11 - m00 - m22, 1.0 + m22 - m00 - m11],
                       dim=-1)
    best = torch.argmax(lead, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)               # (..., 4, 4)
    q = torch.gather(cands, -2, best[..., None, None].expand(
        best.shape + (1, 4)))[..., 0, :]
    q = quat_normalize(q)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


# ---------------------------------------------------------------------------
# SO(3) exp/log (angle-axis).
# ---------------------------------------------------------------------------

def skew(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix [w]x."""
    x, y, z = w.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(w.shape[:-1] + (3, 3))


def _sin_terms(theta2: torch.Tensor):
    """A = sin(t)/t and B = (1 - cos t)/t^2 with small-angle Taylor
    branches, for theta2 of shape (..., 1, 1)."""
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    return theta, small, A, B


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Angle-axis (..., 3) -> rotation matrix (..., 3, 3), Rodrigues."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    _, _, A, B = _sin_terms(theta2)
    K = skew(w)
    return _eye(3, w, K.shape[:-2]) + A * K + B * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> angle-axis, via the quaternion log."""
    q = matrix_to_quat(R)
    w = q[..., 0:1]
    v = q[..., 1:]
    vnorm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    angle = 2.0 * torch.arctan2(vnorm, w)
    scale = torch.where(vnorm < _EPS, 2.0 / torch.clamp(w, min=_EPS),
                        angle / torch.clamp(vnorm, min=_EPS))
    return v * scale


# ---------------------------------------------------------------------------
# SE(3): (R | t) pairs, world-to-camera (x_cam = R x_world + t).
# ---------------------------------------------------------------------------

def se3_exp(xi: torch.Tensor):
    """Twist (..., 6) = (w, v) -> (R, t) with the exact V matrix."""
    w, v = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    theta, small, _, B = _sin_terms(theta2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    K = skew(w)
    V = _eye(3, xi, K.shape[:-2]) + B * K + C * (K @ K)
    return R, _mv(V, v)


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> twist (..., 6)."""
    w = so3_log(R)
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    _, small, A, B = _sin_terms(theta2)
    # V^-1 = I - K/2 + (1/theta^2)(1 - A/(2B)) K^2
    coef = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                       (1.0 - A / (2.0 * B)) / theta2)
    K = skew(w)
    Vinv = _eye(3, R, K.shape[:-2]) - 0.5 * K + coef * (K @ K)
    return torch.cat([w, _mv(Vinv, t)], dim=-1)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) o (Rb, tb): apply b first, then a."""
    return Ra @ Rb, _mv(Ra, tb) + ta


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -_mv(Rt, t)


def se3_apply(R, t, X):
    return _mv(R, X) + t


# ---------------------------------------------------------------------------
# Sim(3): x -> s R x + t.
# ---------------------------------------------------------------------------

def sim3_compose(Ra, ta, sa, Rb, tb, sb):
    """(Ra, ta, sa) o (Rb, tb, sb): apply b first, then a."""
    return Ra @ Rb, sa[..., None] * _mv(Ra, tb) + ta, sa * sb


def sim3_inverse(R, t, s):
    Rt = R.transpose(-1, -2)
    sinv = 1.0 / s
    return Rt, -sinv[..., None] * _mv(Rt, t), sinv


def _inv3(M):
    """Closed-form 3x3 inverse: the adjugate is three cross products."""
    a, b, c = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    r0 = cross(b, c)
    r1 = cross(c, a)
    r2 = cross(a, b)
    det = torch.sum(a * r0, dim=-1)[..., None, None]
    return torch.stack([r0, r1, r2], dim=-1) / det


def _sim3_W(w, sigma, terms: int = 18):
    """W(w, sigma) = sum_k M^k / (k+1)!  with  M = [w]_x + sigma I, the
    left Jacobian mapping the translational tangent to the group
    translation (t = W u); the reference's truncated series."""
    eye = _eye(3, w, w.shape[:-1])
    M = skew(w) + sigma[..., None, None] * eye
    W = eye
    term = eye
    for k in range(1, terms):
        term = term @ M / (k + 1.0)
        W = W + term
    return W


def sim3_log(R, t, s):
    """(R, t, s) -> (..., 7) tangent [w(3), u(3), sigma(1)]."""
    w = so3_log(R)
    sigma = torch.log(s)
    u = _mv(_inv3(_sim3_W(w, sigma)), t)
    return torch.cat([w, u, sigma[..., None]], dim=-1)


# ---------------------------------------------------------------------------
# Yaw-pitch-roll: rotation(psi, theta, phi) = Rz(psi) Ry(theta) Rx(phi).
# ---------------------------------------------------------------------------

def _rotation(a, pattern) -> torch.Tensor:
    a = torch.as_tensor(a)
    c, s = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    vals = {"c": c, "s": s, "-s": -s, "1": one, "0": zero}
    m = torch.stack([vals[p] for p in pattern], dim=-1)
    return m.reshape(a.shape + (3, 3))


def rotation_ypr(psi, theta, phi) -> torch.Tensor:
    """Rz(psi) @ Ry(theta) @ Rx(phi)."""
    return rotation_z(psi) @ rotation_y(theta) @ rotation_x(phi)


def rotation_x(a) -> torch.Tensor:
    return _rotation(a, ("1", "0", "0", "0", "c", "-s", "0", "s", "c"))


def rotation_y(a) -> torch.Tensor:
    return _rotation(a, ("c", "0", "s", "0", "1", "0", "-s", "0", "c"))


def rotation_z(a) -> torch.Tensor:
    return _rotation(a, ("c", "-s", "0", "s", "c", "0", "0", "0", "1"))


def matrix_to_ypr(R: torch.Tensor):
    """Extract (yaw, pitch, roll) with R = Rz(yaw) Ry(pitch) Rx(roll)."""
    yaw = torch.arctan2(R[..., 1, 0], R[..., 0, 0])
    pitch = torch.arcsin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    roll = torch.arctan2(R[..., 2, 1], R[..., 2, 2])
    return yaw, pitch, roll


# ---------------------------------------------------------------------------
# RQ factorization and projection-matrix decomposition (Hartley-Zisserman
# section 6.2.4).
# ---------------------------------------------------------------------------

def rq_factorization(A: torch.Tensor):
    """Factor A = R @ Q with R upper triangular (positive diagonal) and Q
    orthogonal, via the flipped-QR identity. Batched over leading dims."""
    n = A.shape[-1]
    flip = torch.eye(n, dtype=A.dtype, device=A.device).flip(0)
    q0, r0 = torch.linalg.qr((flip @ A).transpose(-1, -2))
    R = flip @ r0.transpose(-1, -2) @ flip
    Q = flip @ q0.transpose(-1, -2)
    d = torch.diagonal(R, dim1=-2, dim2=-1)
    s = torch.where(d < 0, -1.0, 1.0).to(A.dtype)
    return R * s[..., None, :], Q * s[..., :, None]


def decompose_projection_matrix(P: torch.Tensor):
    """Split a 3x4 projection P ~ K [R | t] into (K, R, t): K upper
    triangular with positive diagonal and K[2, 2] == 1, R a proper
    rotation. Batched over leading dims."""
    M = P[..., :, :3]
    sign = torch.where(torch.linalg.det(M) < 0, -1.0, 1.0).to(P.dtype)
    P = P * sign[..., None, None]
    K, R = rq_factorization(P[..., :, :3])
    t = torch.linalg.solve(K, P[..., :, 3:])[..., 0]
    return K / K[..., 2:3, 2:3], R, t
