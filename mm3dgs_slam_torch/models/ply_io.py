"""Binary PLY checkpoint I/O in the reference's attribute schema (JAX
counterpart: models/ply_io.py; gaussian_model.py:205-257):

  x y z nx ny nz f_dc_{0..2} f_rest_{0..3R-1} opacity scale_{0..2}
  rot_{0..3} rgb_{0..2}           (float32, binary little-endian)

Rows are interleaved by the native C++ codec (native/libply_codec.so at the
repository root, multithreaded, bound with ctypes as the JAX package binds
it) when that library loads, else by numpy; the two write the same bytes.
`native_loaded()` says which path saving takes.
"""
from __future__ import annotations

import ctypes
import os
import re
from pathlib import Path

import numpy as np

NATIVE_LIB = Path(__file__).resolve().parents[2] / "native" / "libply_codec.so"
_NATIVE = None   # None: not tried yet; False: unavailable; else the library
_F32P = ctypes.POINTER(ctypes.c_float)


def _native():
    """The native codec, loaded on first use; None where it does not load."""
    global _NATIVE
    if _NATIVE is None:
        try:
            lib = ctypes.CDLL(str(NATIVE_LIB))
            lib.ply_pack_rows.argtypes = [ctypes.c_int64] * 3 + [_F32P] * 8
            lib.ply_unpack_rows.argtypes = [ctypes.c_int64] * 3 + [_F32P] * 8
            lib.ply_pack_rows.restype = lib.ply_unpack_rows.restype = None
            lib.ply_row_stride.argtypes = [ctypes.c_int64] * 2
            lib.ply_row_stride.restype = ctypes.c_int64
            _NATIVE = lib
        except (OSError, AttributeError):
            _NATIVE = False
    return _NATIVE or None


def native_loaded() -> bool:
    """Whether save_ply interleaves rows with the native codec."""
    return _native() is not None


def _pack_native(lib, xyz, features_dc, features_rest, opacity, scaling, rotation, rgb):
    n, n_dc, n_rest = xyz.shape[0], features_dc.shape[1], features_rest.shape[1]
    cols = np.empty((n, lib.ply_row_stride(n_dc, n_rest)), dtype="<f4")
    args = [np.ascontiguousarray(a, dtype=np.float32)
            for a in (xyz, features_dc, features_rest, opacity, scaling, rotation, rgb)]
    lib.ply_pack_rows(n, n_dc, n_rest, *(a.ctypes.data_as(_F32P) for a in args),
                      cols.ctypes.data_as(_F32P))
    return cols


def _pack_numpy(xyz, features_dc, features_rest, opacity, scaling, rotation, rgb):
    n = xyz.shape[0]
    # channel-major SH flattening (torch .transpose(1, 2).flatten(1))
    f_dc = np.transpose(features_dc, (0, 2, 1)).reshape(n, 3 * features_dc.shape[1])
    f_rest = np.transpose(features_rest, (0, 2, 1)).reshape(n, 3 * features_rest.shape[1])
    return np.concatenate([xyz, np.zeros_like(xyz), f_dc, f_rest, opacity, scaling,
                           rotation, rgb], axis=1).astype("<f4")


def _attribute_names(n_rest: int) -> list[str]:
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(3)]
    names += [f"f_rest_{i}" for i in range(3 * n_rest)]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(3)]
    names += [f"rot_{i}" for i in range(4)]
    names += [f"rgb_{i}" for i in range(3)]
    return names


def save_ply(path, xyz, features_dc, features_rest, opacity, scaling,
             rotation, rgb) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n, n_rest = xyz.shape[0], features_rest.shape[1]
    arrays = (xyz, features_dc, features_rest, opacity, scaling, rotation, rgb)
    lib = _native() if n > 0 else None
    cols = _pack_native(lib, *arrays) if lib is not None else _pack_numpy(*arrays)
    names = _attribute_names(n_rest)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {a}" for a in names] + ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(np.ascontiguousarray(cols).tobytes())


def load_ply(path: str) -> dict:
    """Read a reference-schema binary little-endian PLY into arrays."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:head_end].decode("ascii").splitlines()
    if header[0].strip() != "ply" or not any("binary_little_endian" in l for l in header):
        raise ValueError(f"{path}: not a binary little-endian PLY")
    n = int([l for l in header if l.startswith("element vertex")][0].split()[-1])
    props = [l.split()[-1] for l in header if l.startswith("property")]
    arr = np.frombuffer(data[head_end:], dtype="<f4", count=n * len(props)).reshape(n, len(props))
    col = {name: arr[:, i] for i, name in enumerate(props)}

    def block(prefix):
        names = sorted((p for p in props if re.fullmatch(rf"{prefix}_\d+", p)),
                       key=lambda s: int(s.split("_")[-1]))
        return np.stack([col[p] for p in names], axis=1) if names else None

    f_rest = block("f_rest")
    n_rest = f_rest.shape[1] // 3 if f_rest is not None else 0
    return {
        "xyz": np.stack([col["x"], col["y"], col["z"]], axis=1),
        "features_dc": block("f_dc").reshape(n, 3, 1).transpose(0, 2, 1),
        "features_rest": (f_rest.reshape(n, 3, n_rest).transpose(0, 2, 1) if n_rest
                          else np.zeros((n, 0, 3), np.float32)),
        "opacity": col["opacity"][:, None],
        "scaling": block("scale"),
        "rotation": block("rot"),
        "rgb": block("rgb") if "rgb_0" in col else np.zeros((n, 3), np.float32),
    }
