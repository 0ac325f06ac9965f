"""Build and bind the port's CUDA kernels (kernels/csrc/*).

The sources are compiled by `nvcc` for sm_90a into one shared library with
a plain C interface, loaded with ctypes. Nothing compiles at import: the
first CUDA launch calls `library()`, which builds into
`kernels/_build/<hash of sources and flags>/` (ignored by git) and reuses
that build in later processes. A missing `nvcc` or a failed build raises.

Float agreement with the reference: no fused multiply-add contraction
(--fmad=false), IEEE division and square root, no fast-math intrinsics.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
SOURCES = ("mt_kernels.cu", "megakernel.cu")
HEADERS = ("mt.cuh",)
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-prec-div=true", "-prec-sqrt=true",
    "--ptxas-options=-v", "-shared", "-Xcompiler", "-fPIC",
)
LIB_NAME = "librt3c_kernels.so"


class RefillParams(ctypes.Structure):
    """Mirror of `RefillParams` in csrc/megakernel.cu, field for field."""

    _fields_ = [
        ("n_pix", ctypes.c_int), ("spp", ctypes.c_int),
        ("width", ctypes.c_int), ("max_depth", ctypes.c_int),
        ("num_lights", ctypes.c_int), ("pixel_base", ctypes.c_int),
        ("subframe_index", ctypes.c_int), ("attr_stride", ctypes.c_int),
        ("light_stride", ctypes.c_int), ("n_tiles", ctypes.c_int),
        ("ct", ctypes.c_int), ("pad_i", ctypes.c_int),
        ("seed_rot", ctypes.c_uint32),
        ("width_f", ctypes.c_float), ("height_f", ctypes.c_float),
        ("tmin", ctypes.c_float), ("tmax", ctypes.c_float),
        ("shadow_tmin", ctypes.c_float), ("shadow_eps", ctypes.c_float),
        ("pick_pdf", ctypes.c_float),
        ("bg", ctypes.c_float * 3),
        ("cam", ctypes.c_float * 12),
    ]


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float]:
    """Compile the library if no build of these exact sources exists.
    Returns (library path, seconds spent compiling; 0.0 when reused)."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    (out_dir / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, seconds


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rt3c_mt_trace.argtypes = [ci, ci, vp, ci, vp, vp, vp, vp, ci, ci,
                                  vp, vp]
    lib.rt3c_mt_trace.restype = ci
    lib.rt3c_trace_shade_refill.argtypes = [
        ci, ctypes.POINTER(RefillParams), vp, vp, vp, ci, vp, vp, vp, vp, vp,
        vp, vp, vp, vp]
    lib.rt3c_trace_shade_refill.restype = ci
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def launch_target(device: torch.device) -> tuple[int, int]:
    """(device index, current stream handle) for a kernel launch."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return index, torch.cuda.current_stream(device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> None:
    """Validate what a kernel takes: CUDA, one device, dtype, contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
