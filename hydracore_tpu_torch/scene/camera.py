"""Camera: matrices + eye-ray generation parameters.

lookAt world-view + perspective projection with the inverse matrices used
by eye-ray generation and thin-lens DOF sampling (the JAX package's
scene/camera.py; RenderDriverRTE::CalcCameraMatrices in the reference).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from hydracore_tpu_torch.scene.statefile import CameraDesc
from hydracore_tpu_torch.utils.device import tree_to
from hydracore_tpu_torch.utils.math3d import np_look_at, np_perspective


@dataclass
class CameraParams:
    pos: object  # (3,)
    mWorldViewInv: object  # (4,4) view -> world
    mProjInv: object  # (4,4)
    lens_radius: object  # scalar f32
    focal_dist: object  # scalar f32
    width: int = 512
    height: int = 512

    def to(self, device) -> "CameraParams":
        return tree_to(self, device)


def build_camera(desc: CameraDesc, width: int, height: int) -> CameraParams:
    view = np_look_at(desc.position, desc.look_at, desc.up)
    proj = np_perspective(desc.fov, float(width) / float(height), desc.near, desc.far)
    focal = desc.focal_dist
    if focal <= 0.0:
        focal = float(np.linalg.norm(desc.look_at - desc.position))
    lens_r = desc.dof_lens_radius if desc.enable_dof else 0.0
    return CameraParams(
        pos=np.asarray(desc.position, np.float32),
        mWorldViewInv=np.linalg.inv(view).astype(np.float32),
        mProjInv=np.linalg.inv(proj).astype(np.float32),
        lens_radius=np.float32(lens_r),
        focal_dist=np.float32(focal),
        width=width,
        height=height,
    )
