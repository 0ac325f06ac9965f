"""Build and bind the port's CUDA kernels (kernels/csrc/*).

The sources are compiled by `nvcc` for sm_90a, one process per source, all
started together, and linked into one shared library with a plain C
interface, loaded with ctypes. Nothing compiles at import: the first CUDA
launch calls `library()`, which builds into
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
SOURCES = ("mt_kernels.cu", "megakernel.cu", "megakernel_aov.cu",
           "external.cu")
HEADERS = ("mt.cuh", "shade.cuh", "megakernel.cuh")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-prec-div=true", "-prec-sqrt=true",
    "--ptxas-options=-v", "-Xcompiler", "-fPIC",
)
LIB_NAME = "librt3c_kernels.so"


class RefillParams(ctypes.Structure):
    """Mirror of `RefillParams` in csrc/megakernel.cuh, field for field."""

    _fields_ = [
        ("n_pix", ctypes.c_int), ("spp", ctypes.c_int),
        ("width", ctypes.c_int), ("max_depth", ctypes.c_int),
        ("num_lights", ctypes.c_int), ("pixel_base", ctypes.c_int),
        ("subframe_index", ctypes.c_int), ("attr_stride", ctypes.c_int),
        ("light_stride", ctypes.c_int), ("n_tiles", ctypes.c_int),
        ("ct", ctypes.c_int), ("motion", ctypes.c_int),
        ("power", ctypes.c_int), ("params_base", ctypes.c_int),
        ("aov", ctypes.c_int), ("seed_rot", ctypes.c_uint32),
        ("width_f", ctypes.c_float), ("height_f", ctypes.c_float),
        ("tmin", ctypes.c_float), ("tmax", ctypes.c_float),
        ("shadow_tmin", ctypes.c_float), ("shadow_eps", ctypes.c_float),
        ("pick_pdf", ctypes.c_float),
        ("bg", ctypes.c_float * 3),
        ("cam", ctypes.c_float * 12),
    ]


class TraceShadeParams(ctypes.Structure):
    """Mirror of `TraceShadeParams` in csrc/megakernel.cuh, field for
    field."""

    _fields_ = [
        ("max_depth", ctypes.c_int), ("num_lights", ctypes.c_int),
        ("attr_stride", ctypes.c_int), ("light_stride", ctypes.c_int),
        ("n_tiles", ctypes.c_int), ("ct", ctypes.c_int),
        ("motion", ctypes.c_int), ("power", ctypes.c_int),
        ("params_base", ctypes.c_int), ("aov", ctypes.c_int),
        ("shadow_tmin", ctypes.c_float), ("shadow_eps", ctypes.c_float),
        ("pick_pdf", ctypes.c_float),
        ("bg", ctypes.c_float * 3),
    ]


class ExternalParams(ctypes.Structure):
    """Mirror of `ExternalParams` in csrc/external.cu, field for field."""

    _fields_ = [
        ("max_depth", ctypes.c_int), ("num_lights", ctypes.c_int),
        ("light_stride", ctypes.c_int), ("motion", ctypes.c_int),
        ("shadow_tmin", ctypes.c_float), ("shadow_eps", ctypes.c_float),
        ("pick_pdf", ctypes.c_float),
        ("bg", ctypes.c_float * 3),
        ("attr_w", ctypes.c_int), ("power", ctypes.c_int),
        ("params_base", ctypes.c_int), ("aov", ctypes.c_int),
    ]


class TexParams(ctypes.Structure):
    """Mirror of `TexParams` in csrc/shade.cuh, field for field: the RGBA8
    atlas and meta table of a textured launch."""

    _fields_ = [
        ("texels", ctypes.c_void_p), ("meta", ctypes.c_void_p),
        ("aw", ctypes.c_int), ("uv_xform", ctypes.c_int),
        ("normal_maps", ctypes.c_int), ("nmap_base", ctypes.c_int),
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
    """Compile the library if no build of these exact sources exists: one
    nvcc per source in parallel, then one link. Returns (library path,
    seconds spent compiling and linking; 0.0 when reused)."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [out_dir / f"{Path(src).stem}.{tag}.o" for src in SOURCES]
    t0 = time.perf_counter()
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in ([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o",
                          str(obj), str(CSRC / src)]
                         for src, obj in zip(SOURCES, objs))]
    log, failed = [], []
    for cmd, proc in procs:
        out, err = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{err}")
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n{proc.stderr}")
    seconds = time.perf_counter() - t0
    (out_dir / "build.log").write_text("\n".join(log))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
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
    tex = ctypes.POINTER(TexParams)
    lib.rt3c_trace_shade_refill.argtypes = [
        ci, ctypes.POINTER(RefillParams), vp, vp, vp, vp, ci, vp, vp, vp, vp,
        vp, vp, vp, vp, vp, tex, vp]
    lib.rt3c_trace_shade_refill.restype = ci
    lib.rt3c_trace_shade.argtypes = [
        ci, ctypes.POINTER(TraceShadeParams), vp, vp, vp, ci, vp, vp, vp, vp,
        vp, vp, vp, vp, vp, tex, vp]
    lib.rt3c_trace_shade.restype = ci
    lib.rt3c_mt_trace_motion.argtypes = [ci, ci, vp, vp, ci, vp, vp, vp, vp,
                                         vp, ci, ci, vp, vp]
    lib.rt3c_mt_trace_motion.restype = ci
    lib.rt3c_external_shade.argtypes = [
        ci, ctypes.POINTER(ExternalParams), vp, vp, vp, vp, ci, vp, ci, vp,
        vp, vp, tex, vp]
    lib.rt3c_external_shade.restype = ci
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
