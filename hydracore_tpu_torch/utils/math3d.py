"""Vector / matrix helpers: torch on device, numpy on the host.

Vectors are (..., 3) float32 tensors. Host-side matrix builders for the
camera stay numpy (scene compilation is host code).
"""
from __future__ import annotations

import math

import numpy as np
import torch

EPS_HIT = 1e-5


def sqrt(x):
    """Correctly rounded square root. PyTorch's vectorized CPU sqrt is one
    ulp off on some float32 inputs (XLA's and CUDA's round correctly);
    on the CPU a float32 root goes through float64, which rounds correctly
    (53 >= 2*24 + 2 bits), so the CPU results match the card's and the JAX
    package's."""
    if x.is_cuda or x.dtype != torch.float32:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def dot3(a, b):
    return (a * b).sum(dim=-1)


def cross3(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def length3(a):
    return sqrt(torch.clamp(dot3(a, a), min=0.0))


def normalize3(a, eps: float = 1e-20):
    return a / sqrt(torch.clamp(dot3(a, a), min=eps))[..., None]


def reflect3(d, n):
    """Reflect direction d about normal n (d points INTO the surface)."""
    return d - 2.0 * dot3(d, n)[..., None] * n


def make_orthonormal_basis(n):
    """(tangent, bitangent) for normal n — branchless Frisvad/Pixar."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    bt = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return t, bt


def map_to_hemisphere(n, u1, u2, power: float = 1.0):
    """Cosine^power-weighted hemisphere sample around n."""
    t, bt = make_orthonormal_basis(n)
    cos_theta = torch.pow(torch.clamp(1.0 - u1, min=1e-10), 1.0 / (power + 1.0))
    sin_theta = sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = 2.0 * math.pi * u2
    return ((sin_theta * torch.cos(phi))[..., None] * t
            + (sin_theta * torch.sin(phi))[..., None] * bt
            + cos_theta[..., None] * n)


def offs_ray_pos(pos, n, direction, eps: float = 1e-4):
    """Offset a secondary-ray origin off the surface along the geometric
    normal (flipped to the side the ray leaves through), scaled with the
    distance from the origin."""
    scale = torch.clamp(pos.abs().amax(dim=-1), min=1.0)
    signed = torch.where(dot3(direction, n) >= 0.0, 1.0, -1.0)
    return pos + (eps * scale * signed)[..., None] * n


def transform_point(m, p):
    """Apply a 4x4 row-major matrix (..., 4, 4) to points (..., 3)."""
    return (m[..., :3, :3] @ p[..., :, None])[..., 0] + m[..., :3, 3]


def transform_dir(m, d):
    return (m[..., :3, :3] @ d[..., :, None])[..., 0]


def transform_normal(m_inv, n):
    """Transform a normal with the inverse matrix (n' = n @ M^-1)."""
    return (n[..., None, :] @ m_inv[..., :3, :3])[..., 0, :]


# ----------------------------------------------------------------------------
# Host-side (numpy) matrix builders for the camera
# ----------------------------------------------------------------------------

def np_look_at(eye, center, up):
    """Right-handed lookAt view matrix (row-major 4x4 numpy array)."""
    eye = np.asarray(eye, np.float32)
    center = np.asarray(center, np.float32)
    up = np.asarray(up, np.float32)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)  # z row is -f, so translation is +f.eye
    return m


def np_perspective(fov_deg: float, aspect: float, z_near: float, z_far: float):
    """OpenGL-style perspective projection (row-major), fov is vertical."""
    ymax = z_near * np.tan(np.deg2rad(fov_deg) * 0.5)
    xmax = ymax * aspect
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = z_near / xmax
    m[1, 1] = z_near / ymax
    m[2, 2] = -(z_far + z_near) / (z_far - z_near)
    m[2, 3] = -2.0 * z_far * z_near / (z_far - z_near)
    m[3, 2] = -1.0
    return m
