"""Core geometry: rotating-camera model, SO(3), projections, focal estimation.

Counterpart of ``pano360_tpu.geometry``: the same closed forms on
PyTorch tensors, batched over leading dimensions and dtype-polymorphic.
A camera maps world rays to centered pixels by ``x ~ K R ray``.
"""
from __future__ import annotations

import dataclasses

import torch

from pano360_tpu_torch import profiling


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Batched) matrix product; full f32 (TF32 is off, see __init__)."""
    return torch.matmul(a, b)


def tree_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` (a power-of-two length) by pairwise halving adds
    (x[:n/2] + x[n/2:], until one is left): elementwise, so every sum
    has one order whatever the shape around it, and a kernel can repeat
    it (on the card a reduction's split follows the shape it is given)."""
    while x.shape[dim] > 1:
        h = x.shape[dim] // 2
        x = x.narrow(dim, 0, h) + x.narrow(dim, h, h)
    return x.squeeze(dim)


def det3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 determinant."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2]
                            - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2]
                              - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1]
                              - m[..., 1, 1] * m[..., 2, 0]))


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse via the adjugate."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co00, co01, co02 = e * i - f * h, c * h - b * i, b * f - c * e
    co10, co11, co12 = f * g - d * i, a * i - c * g, c * d - a * f
    co20, co21, co22 = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * co00 + d * co01 + g * co02
    adj = torch.stack([
        torch.stack([co00, co01, co02], dim=-1),
        torch.stack([co10, co11, co12], dim=-1),
        torch.stack([co20, co21, co22], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


@dataclasses.dataclass
class Camera:
    """Batched rotating-camera parameters: ``rot``, ``intr`` (..., 3, 3)."""

    rot: torch.Tensor
    intr: torch.Tensor

    def hom(self) -> torch.Tensor:
        return cam_hom(self.rot, self.intr)

    def proj(self) -> torch.Tensor:
        return cam_proj(self.rot, self.intr)


def cam_hom(rot: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """Pixel -> world-ray homography ``R^T K^-1``."""
    return mm(rot.transpose(-1, -2), inv3x3(intr))


def cam_proj(rot: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """World-ray -> pixel projection ``K R``."""
    return mm(intr, rot)


def hom_to_from(cam1: Camera, cam2: Camera) -> torch.Tensor:
    """Homography mapping pixels of ``cam2`` into ``cam1``."""
    return mm(cam_proj(cam1.rot, cam1.intr), cam_hom(cam2.rot, cam2.intr))


def intrinsics(focal, center=(0.0, 0.0)) -> torch.Tensor:
    """Intrinsic matrix from a focal and principal point (broadcasts)."""
    focal = torch.as_tensor(focal)
    cx = torch.as_tensor(center[0], dtype=focal.dtype, device=focal.device)
    cy = torch.as_tensor(center[1], dtype=focal.dtype, device=focal.device)
    z = torch.zeros_like(focal)
    o = torch.ones_like(focal)
    return torch.stack([
        torch.stack([focal, z, cx * o], dim=-1),
        torch.stack([z, focal, cy * o], dim=-1),
        torch.stack([z, z, o], dim=-1),
    ], dim=-2)


def cross_mat(vec: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrix; batched."""
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def exp_so3(rad: torch.Tensor) -> torch.Tensor:
    """Rodrigues ``I + a K + b K^2`` with Taylor guards near zero (exact
    at the origin and differentiable there)."""
    t2 = torch.sum(rad * rad, dim=-1)[..., None, None]
    small = t2 < 1e-12
    t = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / t2)
    cross = cross_mat(rad)
    eye = torch.eye(3, dtype=rad.dtype, device=rad.device).expand(
        cross.shape)
    return eye + a * cross + b * mm(cross, cross)


def log_so3(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle vector (cutoff at ``|v| < 1e-7``)."""
    rad = torch.stack([
        rot[..., 2, 1] - rot[..., 1, 2],
        rot[..., 0, 2] - rot[..., 2, 0],
        rot[..., 1, 0] - rot[..., 0, 1],
    ], dim=-1)
    mod = torch.linalg.norm(rad, dim=-1, keepdim=True)
    tr = (rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2])[..., None]
    theta = torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))
    safe = torch.where(mod < 1e-7, torch.ones_like(mod), mod)
    return torch.where(mod < 1e-7, torch.zeros_like(rad), rad * theta / safe)


def nearest_rotation(mat: torch.Tensor) -> torch.Tensor:
    """Closest rotation in Frobenius norm via SVD (on a card, its result
    checks sync twice)."""
    profiling.count("host_syncs", 2)
    uu, _, vt = torch.linalg.svd(mat)
    rot = mm(uu, vt)
    return rot * torch.sign(det3x3(rot))[..., None, None]


class SphProj:
    """Forward/backward spherical projection, batched."""

    @staticmethod
    def hom2proj(pts: torch.Tensor) -> torch.Tensor:
        hypot = torch.sqrt(pts[..., 0] ** 2 + pts[..., 2] ** 2)
        return torch.stack([torch.atan2(pts[..., 0], pts[..., 2]),
                            torch.atan2(pts[..., 1], hypot)], dim=-1)

    @staticmethod
    def proj2hom(pts: torch.Tensor) -> torch.Tensor:
        return torch.stack([torch.sin(pts[..., 0]), torch.tan(pts[..., 1]),
                            torch.cos(pts[..., 0])], dim=-1)


class CylProj:
    """Forward/backward cylindrical projection, batched: the middle ray
    coordinate is the height itself instead of ``tan`` of an angle."""

    @staticmethod
    def hom2proj(pts: torch.Tensor) -> torch.Tensor:
        hypot = torch.sqrt(pts[..., 0] ** 2 + pts[..., 2] ** 2)
        return torch.stack([torch.atan2(pts[..., 0], pts[..., 2]),
                            pts[..., 1] / hypot], dim=-1)

    @staticmethod
    def proj2hom(pts: torch.Tensor) -> torch.Tensor:
        return torch.stack([torch.sin(pts[..., 0]), pts[..., 1],
                            torch.cos(pts[..., 0])], dim=-1)


PROJECTIONS = {"spherical": SphProj, "cylindrical": CylProj}


def _focal_from_two(v1, v2, d1, d2):
    swap = v1 < v2
    hi = torch.where(swap, v2, v1)
    lo = torch.where(swap, v1, v2)
    both = torch.where(torch.abs(d1) > torch.abs(d2), hi, lo)
    one = torch.ones_like(hi)
    f_both = torch.sqrt(torch.where(both > 0, both, one))
    f_hi = torch.sqrt(torch.where(hi > 0, hi, one))
    return torch.where((hi > 0) & (lo > 0), f_both,
                       torch.where(hi > 0, f_hi, torch.zeros_like(f_hi)))


def _focal_one_side(hom: torch.Tensor) -> torch.Tensor:
    h = hom.reshape(hom.shape[:-2] + (9,))
    d1 = h[..., 6] * h[..., 7]
    d2 = (h[..., 7] - h[..., 6]) * (h[..., 7] + h[..., 6])
    v1 = -(h[..., 0] * h[..., 1] + h[..., 3] * h[..., 4]) / d1
    v2 = (h[..., 0] ** 2 + h[..., 3] ** 2
          - h[..., 1] ** 2 - h[..., 4] ** 2) / d2
    f1 = _focal_from_two(v1, v2, d1, d2)

    d1b = h[..., 0] * h[..., 3] + h[..., 1] * h[..., 4]
    d2b = h[..., 0] ** 2 + h[..., 1] ** 2 - h[..., 3] ** 2 - h[..., 4] ** 2
    v1b = -h[..., 2] * h[..., 5] / d1b
    v2b = (h[..., 5] ** 2 - h[..., 2] ** 2) / d2b
    f0 = _focal_from_two(v1b, v2b, d1b, d2b)
    return torch.sqrt(f0 * f1)


def focal_from_hom(hom: torch.Tensor) -> torch.Tensor:
    """Szeliski-Shum focal from a homography, else from its inverse."""
    f_fwd = _focal_one_side(hom)
    f_inv = _focal_one_side(inv3x3(hom))
    return torch.where(f_fwd > 0, f_fwd, f_inv)


PARAMS_PER_CAMERA = 6  # (focal, ppx, ppy, rx, ry, rz)


def params_to_camera(params: torch.Tensor) -> Camera:
    """(focal, ppx, ppy, rx, ry, rz) vector(s) -> Camera; batched."""
    intr = intrinsics(params[..., 0], (params[..., 1], params[..., 2]))
    return Camera(rot=exp_so3(params[..., 3:6]), intr=intr)


def camera_to_params(cam: Camera) -> torch.Tensor:
    """Camera -> 6-vector(s)."""
    intr = cam.intr
    lead = torch.stack([intr[..., 0, 0], intr[..., 0, 2], intr[..., 1, 2]],
                       dim=-1)
    return torch.cat([lead, log_so3(cam.rot)], dim=-1)


def straighten(rots: torch.Tensor) -> torch.Tensor:
    """Global rotation putting all camera x-axes on a common plane.

    ``rots``: (N, 3, 3) -> (N, 3, 3) straightened rotations.
    """
    xs = rots[:, 0, :]
    # cov's check of its divisor, the SVD's two checks, the flip's read
    profiling.count("host_syncs", 4)
    cov = torch.cov(xs.T)
    _, _, vt = torch.linalg.svd(cov)
    v_y = vt[2]
    v_z = torch.sum(rots[:, 2, :], dim=0)
    v_x = torch.linalg.cross(v_y, v_z)
    v_x = v_x / torch.linalg.norm(v_x)
    v_z = torch.linalg.cross(v_x, v_y)
    flip = -1.0 if float(torch.sum(xs * v_x)) < 0 else 1.0
    rot_g = torch.stack([v_x * flip, v_y * flip, v_z], dim=-1)
    return mm(rots, rot_g)


__all__ = [
    "Camera", "cam_hom", "cam_proj", "hom_to_from", "intrinsics",
    "cross_mat", "exp_so3", "log_so3", "nearest_rotation", "SphProj",
    "CylProj", "PROJECTIONS", "focal_from_hom", "params_to_camera",
    "camera_to_params", "PARAMS_PER_CAMERA", "straighten", "det3x3",
    "inv3x3", "tree_sum",
]
