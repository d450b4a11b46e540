"""Pinhole camera and projection matrix (JAX counterpart: ops/camera.py).

The camera is a hashable NamedTuple of Python numbers; the tile edge is the
CUDA kernels' block edge (16x16 pixels, one thread per pixel).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

TILE = 16
PIX = TILE * TILE  # pixels per tile = threads per kernel block


class Camera(NamedTuple):
    """Pinhole camera with principal point (reference renderer.py:46-77)."""

    height: int
    width: int
    fx: float
    fy: float
    cx: float
    cy: float
    znear: float = 0.01
    zfar: float = 100.0

    @property
    def tanfovx(self) -> float:
        return self.width / (2.0 * self.fx)

    @property
    def tanfovy(self) -> float:
        return self.height / (2.0 * self.fy)

    @property
    def tiles_x(self) -> int:
        return math.ceil(self.width / TILE)

    @property
    def tiles_y(self) -> int:
        return math.ceil(self.height / TILE)

    @property
    def n_tiles(self) -> int:
        return self.tiles_x * self.tiles_y


def projection_matrix(cam: Camera, device=None) -> torch.Tensor:
    """OpenGL-style projection with principal point (getProjectionMatrix2,
    reference utils/graphics_utils.py:85-94), column convention."""
    znear, zfar = cam.znear, cam.zfar
    w, h = cam.width, cam.height
    return torch.tensor(
        [
            [2 * cam.fx / w, 0.0, -(w - 2 * cam.cx) / w, 0.0],
            [0.0, 2 * cam.fy / h, -(h - 2 * cam.cy) / h, 0.0],
            [0.0, 0.0, zfar / (zfar - znear), -(zfar * znear) / (zfar - znear)],
            [0.0, 0.0, 1.0, 0.0],
        ],
        dtype=torch.float32, device=device,
    )
