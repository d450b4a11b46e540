"""The three CUDA compositing kernels: build, ctypes binding, launch counts
and the wrappers the render path calls. Kernel 2 (`composite_bwd`) runs as
two launches from one source, its per-slot rows (`composite_bwd_rows`,
counted as `composite_bwd`) and the slot reduce (`slot_reduce`, counted on
its own).

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

Every wrapper also takes a tile window (`tile_lo`, `n_local`, the
tile-sharded render's: parallel/tile_sharded.py): the bins and the per-tile
outputs then have n_local rows for the global tiles from tile_lo on, and the
launch is also counted in `launches_windowed`. The whole grid (tile_lo 0,
n_local n_tiles) is the default.

Each of the four wrappers the render path calls is a `kernel.<name>` span
(spans.py) with its width nc and its pairs and tiles: a launch's checks,
allocations and launch on the host, on the CPU its plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch

from .. import spans
from . import composite as plain
from .binning import SlotTable, build_slots
from .camera import PIX, Camera

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_F = ctypes.c_float


class Kernel:
    """One C entry point of a CUDA source and its launch count."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: list):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.launches_by_nc: dict[int, int] = {}
        self.launches_windowed = 0
        self.ptxas_log = ""
        self._fn = None

    def library_path(self) -> Path:
        h = hashlib.sha256()
        for p in (CSRC / self.source, CSRC / "composite_common.cuh"):
            h.update(p.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{Path(self.source).stem}-{h.hexdigest()[:12]}.so"

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

    def launch(self, *args, nc: int, windowed: bool):
        """Calls the entry point with `args` and counts the launch at width
        `nc`, and as windowed where it walks (or reduces) a tile window
        that is not the whole grid."""
        err = self.bind()(*args)
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.name} was not launched: "
                               f"cudaError {err}")
        self.launches += 1
        self.launches_by_nc[nc] = self.launches_by_nc.get(nc, 0) + 1
        if windowed:
            self.launches_windowed += 1


# packed, ld, pair_gauss, tile_start, tile_count, tile_lo, n_local, n_tiles,
# tiles_x, nc
_COMMON = [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I]
# The feature widths each kernel is compiled for, those its callers use:
# mapping nc 3 (4 with the depth-estimate loss), tracking 5, evaluation 6.
FWD_NC, BWD_NC, POSE_BWD_NC = (3, 4, 5, 6), (3, 4), (5, 6)
FWD = Kernel("composite_fwd", "composite_fwd.cu", "mm3dgs_composite_fwd",
             _COMMON + [_P, _P, _P, _P])
BWD = Kernel("composite_bwd", "composite_bwd.cu", "mm3dgs_composite_bwd_rows",
             _COMMON + [_P, _P, _P, _P, _P, _P, _P])
# rows, nf, gauss_start, gauss_slot, n, dpacked, stream
REDUCE = Kernel("slot_reduce", "composite_bwd.cu", "mm3dgs_slot_reduce",
                [_P, _I, _P, _P, _I, _P, _P])
POSE_BWD = Kernel("composite_pose_bwd", "composite_pose_bwd.cu",
                  "mm3dgs_composite_pose_bwd",
                  _COMMON + [_P, _P, _P, _P, _F, _F, _F, _F, _P, _P, _P])
KERNELS = (FWD, BWD, REDUCE, POSE_BWD)


def _nvcc() -> str:
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")


def build_kernels() -> None:
    """Compile every source whose library is missing, one nvcc per source,
    all in parallel; raises on a failed build."""
    todo = {k.library_path(): k.source for k in KERNELS if not k.library_path().exists()}
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for out, source in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / source)]
        procs.append((source, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for source, out, tmp, p in procs:
        log, _ = p.communicate()
        for k in KERNELS:
            if k.source == source:
                k.ptxas_log = log
        if p.returncode != 0:
            failed.append(f"{source}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
        k.launches_by_nc = {}
        k.launches_windowed = 0


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def launch_counts_by_nc() -> dict[str, dict[int, int]]:
    return {k.name: dict(sorted(k.launches_by_nc.items())) for k in KERNELS}


def launch_counts_windowed() -> dict[str, int]:
    return {k.name: k.launches_windowed for k in KERNELS}


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


def _window(cam: Camera, tile_lo: int, n_local: int | None) -> int:
    """The window's tile count; a window may run past the grid (its pad)."""
    n_local = cam.n_tiles - tile_lo if n_local is None else n_local
    if tile_lo < 0 or n_local <= 0:
        raise ValueError(f"tile window [{tile_lo}, {tile_lo} + {n_local}) of a grid of "
                         f"{cam.n_tiles} tiles is empty or starts before it")
    return n_local


def _tiles(cam: Camera, tile_lo: int, n_local: int | None) -> int:
    return cam.n_tiles - tile_lo if n_local is None else n_local


def _windowed(cam: Camera, tile_lo: int, n_local: int) -> bool:
    return tile_lo != 0 or n_local != cam.n_tiles


def _check_bins(packed, pair_gauss, tile_start, tile_count, n_local, ld_min):
    if packed.dim() != 2 or packed.shape[1] < ld_min:
        raise ValueError(f"packed: expected [N, >={ld_min}], got {tuple(packed.shape)}")
    _check("packed", packed, torch.float32)
    # the kernels read rows as float4s
    if packed.shape[1] % 4 or packed.data_ptr() % 16:
        raise ValueError(f"packed: rows must be 16-B aligned (ld {packed.shape[1]}, "
                         f"address {packed.data_ptr():#x})")
    _check("pair_gauss", pair_gauss, torch.int32)
    _check("tile_start", tile_start, torch.int32, (n_local,))
    _check("tile_count", tile_count, torch.int32, (n_local,))
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
                  work=None, tile_lo: int = 0, n_local: int | None = None):
    """Kernel 1: (acc [n_local, nc, 256], tfin [n_local, 1, 256])."""
    with spans.span("kernel.composite_fwd", nc=nc, pairs=pair_gauss.shape[0],
                    tiles=_tiles(cam, tile_lo, n_local)):
        if not packed.is_cuda:
            _no_work_on_cpu(work)
            return plain.composite_fwd_plain(packed, pair_gauss, tile_start, tile_count, cam,
                                             nc, tile_lo=tile_lo, n_local=n_local)
        n_local = _window(cam, tile_lo, n_local)
        _check_nc(FWD, nc, FWD_NC)
        _check_bins(packed, pair_gauss, tile_start, tile_count, n_local, 6 + nc)
        work_ptr = _work_ptr(work, packed.device)
        acc = torch.empty((n_local, nc, PIX), dtype=torch.float32, device=packed.device)
        tfin = torch.empty((n_local, 1, PIX), dtype=torch.float32, device=packed.device)
        FWD.launch(packed.data_ptr(), packed.shape[1], pair_gauss.data_ptr(),
                   tile_start.data_ptr(), tile_count.data_ptr(), tile_lo, n_local, cam.n_tiles,
                   cam.tiles_x, nc, acc.data_ptr(), tfin.data_ptr(), work_ptr, _stream(),
                   nc=nc, windowed=_windowed(cam, tile_lo, n_local))
        return acc, tfin


def _check_grads(n_local, nc, acc, tfin, dacc, dtfin):
    for name, t, c in (("acc", acc, nc), ("dacc", dacc, nc), ("tfin", tfin, 1),
                       ("dtfin", dtfin, 1)):
        _check(name, t, torch.float32, (n_local, c, PIX))


def composite_bwd(packed, pair_gauss, tile_start, tile_count, acc, tfin, dacc,
                  dtfin, cam: Camera, nc: int, work=None, tile_lo: int = 0,
                  n_local: int | None = None, slots: SlotTable | None = None):
    """Kernel 2: dpacked [N, 16], the mapping backward (of the window's tiles:
    every row of packed, each the sum over the window's pairs), as two
    launches that add in a fixed order, so that dpacked is the same bits on
    every call: `composite_bwd_rows`, then `slot_reduce`. `slots` is
    `binning.build_slots(pair_gauss, N)`, built here when not given (the
    mapping loop builds it once per set of bins)."""
    rows = composite_bwd_rows(packed, pair_gauss, tile_start, tile_count, acc, tfin, dacc,
                              dtfin, cam, nc, work, tile_lo, n_local)
    n = packed.shape[0]
    if slots is None:
        slots = build_slots(pair_gauss, n)
    n_local = _window(cam, tile_lo, n_local)
    return slot_reduce(rows, slots, n, windowed=_windowed(cam, tile_lo, n_local))


def composite_bwd_rows(packed, pair_gauss, tile_start, tile_count, acc, tfin, dacc,
                       dtfin, cam: Camera, nc: int, work=None, tile_lo: int = 0,
                       n_local: int | None = None):
    """Kernel 2's first pass: rows [P, 6 + nc], one per (tile, pair) slot of
    the window's bins (P = len(pair_gauss)), its gradient summed over the
    tile's pixels (zero where no pixel uses the pair). The kernel writes
    the slots tile_start[t] .. tile_start[t] + tile_count[t] - 1 of each
    tile t, so pair_gauss must hold the window's pairs and no others, as
    `binning.build_bins` gives them (P = tile_start[-1] + tile_count[-1])."""
    with spans.span("kernel.composite_bwd_rows", nc=nc, pairs=pair_gauss.shape[0],
                    tiles=_tiles(cam, tile_lo, n_local)):
        if not packed.is_cuda:
            _no_work_on_cpu(work)
            return plain.composite_bwd_pairs_plain(packed, pair_gauss, tile_start, tile_count,
                                                   acc, tfin, dacc, dtfin, cam, nc,
                                                   tile_lo=tile_lo, n_local=n_local)
        n_local = _window(cam, tile_lo, n_local)
        _check_nc(BWD, nc, BWD_NC)
        _check_bins(packed, pair_gauss, tile_start, tile_count, n_local, 6 + nc)
        _check_grads(n_local, nc, acc, tfin, dacc, dtfin)
        work_ptr = _work_ptr(work, packed.device)
        rows = torch.empty((pair_gauss.shape[0], 6 + nc), dtype=torch.float32,
                           device=packed.device)
        BWD.launch(packed.data_ptr(), packed.shape[1], pair_gauss.data_ptr(),
                   tile_start.data_ptr(), tile_count.data_ptr(), tile_lo, n_local, cam.n_tiles,
                   cam.tiles_x, nc, acc.data_ptr(), tfin.data_ptr(), dacc.data_ptr(),
                   dtfin.data_ptr(), rows.data_ptr(), work_ptr, _stream(), nc=nc,
                   windowed=_windowed(cam, tile_lo, n_local))
        return rows


def slot_reduce(rows, slots: SlotTable, n: int, windowed: bool = False):
    """Kernel 2's second pass: dpacked [n, 16], row g the sum of Gaussian g's
    slots' rows (rows [P, 6 + nc]) in ascending slot order, the columns past
    6 + nc zero. `windowed` counts the launch as a tile window's."""
    with spans.span("kernel.slot_reduce", nc=rows.shape[1] - 6, pairs=rows.shape[0], n=n):
        if not rows.is_cuda:
            return plain.slot_reduce_plain(rows, slots, n)
        nf = rows.shape[1]
        _check_nc(REDUCE, nf - 6, BWD_NC)
        _check("rows", rows, torch.float32)
        _check("gauss_start", slots.gauss_start, torch.int32, (n + 1,))
        _check("gauss_slot", slots.gauss_slot, torch.int32, (rows.shape[0],))
        for name, t in (("gauss_start", slots.gauss_start), ("gauss_slot", slots.gauss_slot)):
            if t.device != rows.device:
                raise ValueError(f"{name} is on {t.device}, rows on {rows.device}")
        dpacked = torch.empty((n, 16), dtype=torch.float32, device=rows.device)
        REDUCE.launch(rows.data_ptr(), nf, slots.gauss_start.data_ptr(),
                      slots.gauss_slot.data_ptr(), n, dpacked.data_ptr(), _stream(), nc=nf - 6,
                      windowed=windowed)
        return dpacked


def composite_pose_bwd(packed32, pair_gauss, tile_start, tile_count, acc, tfin,
                       dacc, dtfin, cam: Camera, nc: int, work=None, tile_lo: int = 0,
                       n_local: int | None = None):
    """Kernel 3: per-tile pose-gradient partials [n_local, 12]."""
    with spans.span("kernel.composite_pose_bwd", nc=nc, pairs=pair_gauss.shape[0],
                    tiles=_tiles(cam, tile_lo, n_local)):
        if not packed32.is_cuda:
            _no_work_on_cpu(work)
            return plain.composite_pose_bwd_plain(packed32, pair_gauss, tile_start,
                                                  tile_count, acc, tfin, dacc, dtfin, cam,
                                                  nc, tile_lo=tile_lo, n_local=n_local)
        n_local = _window(cam, tile_lo, n_local)
        _check_nc(POSE_BWD, nc, POSE_BWD_NC)
        _check_bins(packed32, pair_gauss, tile_start, tile_count, n_local, 28)
        _check_grads(n_local, nc, acc, tfin, dacc, dtfin)
        work_ptr = _work_ptr(work, packed32.device)
        psum = torch.empty((n_local, 12), dtype=torch.float32, device=packed32.device)
        POSE_BWD.launch(packed32.data_ptr(), packed32.shape[1], pair_gauss.data_ptr(),
                        tile_start.data_ptr(), tile_count.data_ptr(), tile_lo, n_local,
                        cam.n_tiles, cam.tiles_x, nc, acc.data_ptr(), tfin.data_ptr(),
                        dacc.data_ptr(), dtfin.data_ptr(), cam.fx, cam.fy, cam.cx - 0.5,
                        cam.cy - 0.5, psum.data_ptr(), work_ptr, _stream(),
                        nc=nc, windowed=_windowed(cam, tile_lo, n_local))
        return psum
