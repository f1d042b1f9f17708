"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each ``.cu`` source is compiled by its own ``nvcc`` for ``sm_90a``, all
of them at once, and the objects are linked into one shared library with
a plain C interface, loaded with ``ctypes``.  A library that includes
PyTorch's headers takes minutes to compile; this one takes seconds.  The
output lands in ``build/vdf_torch_kernels/<digest>/`` at the
root of the checkout, keyed by a digest of the sources and flags, so a
changed source rebuilds and an unchanged one loads the cached library.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero value into an
exception.  A failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_ROOT = _PKG_DIR.parent / "build" / "vdf_torch_kernels"
LIB_NAME = "libvdf_torch.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
# C signatures of the entry points (csrc/*.cu); every one returns cudaError_t
_SIGNATURES = {
    # cubes u8[B,4096], dct f32[10,16] (kept DCT-II rows), out i32[B,32], B, stream
    "vdf_hash_dct": (_P, _P, _P, _I64, _P),
    # rows, cols, bounds, row_lo (or NULL), first_ct, n_ct,
    # counts (zeroed), row_tiles, rt0, slots, n, tol, stream
    "vdf_band_counts": (_P, _P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _P),
    # rows, cols, bounds, row_lo (or NULL), hits i32[H,2],
    # words i32[H,4,128], H, chunk (hits per block), n, tol, stream
    "vdf_band_pack": (_P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _P),
    # packed, bounds, first_ct, n_ct, tile_off i64[R], counts i32[R,slots],
    # words i32[tiles,4,128], R, rt0, slots, n, tol, stream
    "vdf_band_sweep": (_P, _P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _P),
}

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
# what the last build did: seconds spent in nvcc (0.0 on a cache hit),
# the library path, and nvcc's output (ptxas register/spill report)
BUILD_INFO: dict = {}


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "no CUDA toolkit found (CUDA_HOME unset and no nvcc on PATH):"
            " the port's kernels cannot be built on this host"
        )
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


def _build() -> Path:
    srcs = _sources()
    h = hashlib.sha256()
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    out = out_dir / LIB_NAME
    if out.exists():
        BUILD_INFO.update(seconds=0.0, path=str(out), log="(cached)")
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    logs: list[str] = []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as work:
        cu = [p for p in srcs if p.suffix == ".cu"]
        objs = [f"{work}/{p.stem}.o" for p in cu]
        # one nvcc per source, all started together, then one link
        jobs = [
            _start([nvcc, *NVCC_FLAGS, "-c", "-o", o, str(p)])
            for o, p in zip(objs, cu)
        ]
        try:
            for job in jobs:
                logs.append(_finish(*job))
        finally:
            for _, proc in jobs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *objs]
        logs.append(_finish(*_start(link)))
    seconds = time.perf_counter() - t0
    os.replace(tmp, out)  # atomic: concurrent builders never see a torn file
    BUILD_INFO.update(seconds=seconds, path=str(out), log="".join(logs))
    return out


def _start(cmd: list[str]) -> tuple[list[str], subprocess.Popen]:
    return cmd, subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
    )


def _finish(cmd: list[str], proc: subprocess.Popen) -> str:
    """Wait for one nvcc; its output (the ptxas report), or raise."""
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}{err}")
    return out + err


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first call; raises if it cannot be."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(_build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.vdf_error_string.argtypes = [ctypes.c_int]
            lib.vdf_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def current_stream(device) -> int:
    """Handle of PyTorch's current stream on ``device``, for a launch."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def ptr(t, what: str) -> int:
    """Device pointer of a contiguous CUDA tensor, 16-byte aligned (the
    kernels load rows as uint4 / float4)."""
    if t.device.type != "cuda" or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(
            f"{what}: needs a contiguous, 16-byte-aligned CUDA tensor"
            f" (got device={t.device}, contiguous={t.is_contiguous()},"
            f" address % 16 = {t.data_ptr() % 16})"
        )
    return t.data_ptr()


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by an entry point."""
    if err != 0:
        msg = load_library().vdf_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
