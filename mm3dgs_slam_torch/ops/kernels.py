"""The three CUDA compositing kernels: build, ctypes binding, launch counts
and the wrappers the render path calls.

Each source under `csrc/` is compiled at first use by its own `nvcc` (all
started together) into a shared library with a plain C interface under
`build/` at the repository root, named by a hash of the sources and flags,
and loaded with ctypes. A wrapper takes the kernel's plain PyTorch version
(`ops/composite.py`) only for tensors on the CPU; for CUDA tensors it checks
device, dtype, shape and contiguity, allocates the outputs, launches the
kernel on the current stream, raises if the launch was refused, and adds one
to that kernel's launch count, in total and at its width nc. There is no
fallback.

All three kernels walk a tile with the same per-warp cull
(`csrc/composite_common.cuh`) and take an optional `work` tensor, int64 [2]
on the card, to which they add the (tile, pair, warp box)s the cull keeps
(`work[0]`, equal to `composite_fwd_plain(count_work=True)`'s `warp_pairs`
whatever nc) and the (warp, pair)s the warps walk (`work[1]`, fewer where a
warp leaves a batch once all its pixels have stopped). The main path passes
none.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch

from . import composite as plain
from .camera import PIX, Camera

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_F = ctypes.c_float


class Kernel:
    """One CUDA source, its C entry point and its launch count."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: list):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.launches_by_nc: dict[int, int] = {}
        self.ptxas_log = ""
        self._fn = None

    def library_path(self) -> Path:
        h = hashlib.sha256()
        for p in (CSRC / self.source, CSRC / "composite_common.cuh"):
            h.update(p.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:12]}.so"

    def bind(self):
        if self._fn is None:
            path = self.library_path()
            if not path.exists():
                build_kernels()
            fn = getattr(ctypes.CDLL(str(path)), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args):
        err = self.bind()(*args)
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.name} was not launched: "
                               f"cudaError {err}")
        self.launches += 1
        nc = args[7]   # every entry point takes nc eighth (_COMMON)
        self.launches_by_nc[nc] = self.launches_by_nc.get(nc, 0) + 1


_COMMON = [_P, _I, _P, _P, _P, _I, _I, _I]  # packed, ld, pairs, tiles, nc
# The feature widths each kernel is compiled for, those its callers use:
# mapping nc 3 (4 with the depth-estimate loss), tracking 5, evaluation 6.
FWD_NC, BWD_NC, POSE_BWD_NC = (3, 4, 5, 6), (3, 4), (5, 6)
FWD = Kernel("composite_fwd", "composite_fwd.cu", "mm3dgs_composite_fwd",
             _COMMON + [_P, _P, _P, _P])
BWD = Kernel("composite_bwd", "composite_bwd.cu", "mm3dgs_composite_bwd",
             _COMMON + [_P, _P, _P, _P, _P, _P, _P])
POSE_BWD = Kernel("composite_pose_bwd", "composite_pose_bwd.cu",
                  "mm3dgs_composite_pose_bwd",
                  _COMMON + [_P, _P, _P, _P, _F, _F, _F, _F, _P, _P, _P])
KERNELS = (FWD, BWD, POSE_BWD)


def _nvcc() -> str:
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")


def build_kernels() -> None:
    """Compile every kernel whose library is missing, one nvcc per source,
    all in parallel; raises on a failed build."""
    todo = [k for k in KERNELS if not k.library_path().exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for k in todo:
        out = k.library_path()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / k.source)]
        procs.append((k, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for k, out, tmp, p in procs:
        log, _ = p.communicate()
        k.ptxas_log = log
        if p.returncode != 0:
            failed.append(f"{k.source}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
        k.launches_by_nc = {}


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def launch_counts_by_nc() -> dict[str, dict[int, int]]:
    return {k.name: dict(sorted(k.launches_by_nc.items())) for k in KERNELS}


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(name, t, dtype, shape=None):
    if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous CUDA {dtype} tensor, "
                         f"got {t.dtype} on {t.device} (contiguous="
                         f"{t.is_contiguous()})")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def _check_nc(kernel, nc, widths):
    if nc not in widths:
        raise ValueError(f"{kernel.name} is compiled for nc in {widths}, got {nc}")


def _check_bins(packed, pair_gauss, tile_start, tile_count, cam, ld_min):
    if packed.dim() != 2 or packed.shape[1] < ld_min:
        raise ValueError(f"packed: expected [N, >={ld_min}], got {tuple(packed.shape)}")
    _check("packed", packed, torch.float32)
    # the kernels read rows as float4s
    if packed.shape[1] % 4 or packed.data_ptr() % 16:
        raise ValueError(f"packed: rows must be 16-B aligned (ld {packed.shape[1]}, "
                         f"address {packed.data_ptr():#x})")
    _check("pair_gauss", pair_gauss, torch.int32)
    _check("tile_start", tile_start, torch.int32, (cam.n_tiles,))
    _check("tile_count", tile_count, torch.int32, (cam.n_tiles,))
    dev = packed.device
    for name, t in (("pair_gauss", pair_gauss), ("tile_start", tile_start),
                    ("tile_count", tile_count)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, packed on {dev}")


def _work_ptr(work, dev) -> int:
    if work is None:
        return 0
    _check("work", work, torch.int64, (2,))
    if work.device != dev:
        raise ValueError(f"work is on {work.device}, packed on {dev}")
    return work.data_ptr()


def _no_work_on_cpu(work):
    if work is not None:
        raise ValueError("work counts the CUDA kernels' cull; the CPU path has none "
                         "(composite_fwd_plain(count_work=True) counts the same)")


def composite_fwd(packed, pair_gauss, tile_start, tile_count, cam: Camera, nc: int,
                  work=None):
    """Kernel 1: (acc [n_tiles, nc, 256], tfin [n_tiles, 1, 256])."""
    if not packed.is_cuda:
        _no_work_on_cpu(work)
        return plain.composite_fwd_plain(packed, pair_gauss, tile_start,
                                         tile_count, cam, nc)
    _check_nc(FWD, nc, FWD_NC)
    _check_bins(packed, pair_gauss, tile_start, tile_count, cam, 6 + nc)
    work_ptr = _work_ptr(work, packed.device)
    acc = torch.empty((cam.n_tiles, nc, PIX), dtype=torch.float32, device=packed.device)
    tfin = torch.empty((cam.n_tiles, 1, PIX), dtype=torch.float32, device=packed.device)
    FWD.launch(packed.data_ptr(), packed.shape[1], pair_gauss.data_ptr(),
               tile_start.data_ptr(), tile_count.data_ptr(), cam.n_tiles, cam.tiles_x,
               nc, acc.data_ptr(), tfin.data_ptr(), work_ptr, _stream())
    return acc, tfin


def _check_grads(cam, nc, acc, tfin, dacc, dtfin):
    for name, t, c in (("acc", acc, nc), ("dacc", dacc, nc), ("tfin", tfin, 1),
                       ("dtfin", dtfin, 1)):
        _check(name, t, torch.float32, (cam.n_tiles, c, PIX))


def composite_bwd(packed, pair_gauss, tile_start, tile_count, acc, tfin, dacc,
                  dtfin, cam: Camera, nc: int, work=None):
    """Kernel 2: dpacked [N, 16], the mapping backward."""
    if not packed.is_cuda:
        _no_work_on_cpu(work)
        return plain.composite_bwd_plain(packed, pair_gauss, tile_start,
                                         tile_count, acc, tfin, dacc, dtfin,
                                         cam, nc)
    _check_nc(BWD, nc, BWD_NC)
    _check_bins(packed, pair_gauss, tile_start, tile_count, cam, 6 + nc)
    _check_grads(cam, nc, acc, tfin, dacc, dtfin)
    work_ptr = _work_ptr(work, packed.device)
    dpacked = torch.zeros((packed.shape[0], 16), dtype=torch.float32, device=packed.device)
    BWD.launch(packed.data_ptr(), packed.shape[1], pair_gauss.data_ptr(),
               tile_start.data_ptr(), tile_count.data_ptr(), cam.n_tiles, cam.tiles_x,
               nc, acc.data_ptr(), tfin.data_ptr(), dacc.data_ptr(), dtfin.data_ptr(),
               dpacked.data_ptr(), work_ptr, _stream())
    return dpacked


def composite_pose_bwd(packed32, pair_gauss, tile_start, tile_count, acc, tfin,
                       dacc, dtfin, cam: Camera, nc: int, work=None):
    """Kernel 3: per-tile pose-gradient partials [n_tiles, 12]."""
    if not packed32.is_cuda:
        _no_work_on_cpu(work)
        return plain.composite_pose_bwd_plain(packed32, pair_gauss, tile_start,
                                              tile_count, acc, tfin, dacc,
                                              dtfin, cam, nc)
    _check_nc(POSE_BWD, nc, POSE_BWD_NC)
    _check_bins(packed32, pair_gauss, tile_start, tile_count, cam, 28)
    _check_grads(cam, nc, acc, tfin, dacc, dtfin)
    work_ptr = _work_ptr(work, packed32.device)
    psum = torch.empty((cam.n_tiles, 12), dtype=torch.float32, device=packed32.device)
    POSE_BWD.launch(packed32.data_ptr(), packed32.shape[1], pair_gauss.data_ptr(),
                    tile_start.data_ptr(), tile_count.data_ptr(), cam.n_tiles, cam.tiles_x,
                    nc, acc.data_ptr(), tfin.data_ptr(), dacc.data_ptr(), dtfin.data_ptr(),
                    cam.fx, cam.fy, cam.cx - 0.5, cam.cy - 0.5, psum.data_ptr(),
                    work_ptr, _stream())
    return psum
