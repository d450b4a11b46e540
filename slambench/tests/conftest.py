"""A cell cut to a size the CPU runs in seconds: 48x64 frames, 300
Gaussians, 5 frames, 6 tracking and 6 mapping iterations; everything else
as the cell's files give it, its limits included."""
from __future__ import annotations

import pytest

from slambench import harness


def tiny_spec(workload: str, h: int = 48, w: int = 64) -> dict:
    spec = harness.cell_spec(workload)
    cfg = spec["config"]["config"]
    cfg["desired_height"], cfg["desired_width"] = h, w
    if spec["traffic"]["kind"] == "synthetic":
        cfg["cam"].update(image_height=h, image_width=w, fx=52.0, fy=52.0,
                          cx=w / 2 - 0.5, cy=h / 2 - 0.5)
        spec["traffic"].update(n_gaussians=300, n_frames=5)
    else:
        cfg["cam"].update(image_height=2 * h, image_width=2 * w, fx=128.0, fy=128.0,
                          cx=w - 0.5, cy=h - 0.5)
        spec["traffic"].update(n_gaussians=300, frames_written=10)
    cfg["tracking"]["iters"], cfg["mapping"]["iters"] = 6, 6
    return spec


def tiny_run_of(workload: str, seed: int, control: bool = False, traced: bool = False):
    return harness.run_cell(tiny_spec(workload), seed, 0.01, traced, "cpu", control=control)


@pytest.fixture(scope="session")
def tiny_run():
    return tiny_run_of("synthetic_tum.orbit", 4000000007, control=True)
