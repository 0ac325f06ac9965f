"""Tracer choice for the path renderer.

Port of rendertoy3c_tpu/trace/auto.py `choose_tracer`, narrowed to the
ported slice: a static scene of up to 2048 faces under the pixel-major
pool gets the fused megakernel pipeline. Everything else raises
NotImplementedError naming the ROADMAP item that adds it.
"""
from __future__ import annotations

from .shade import FusedPipeline, fused_unsupported


def choose_tracer(scene, cfg, device):
    """(scene, tracer) for rendering `scene` under `cfg` on `device`."""
    reason = fused_unsupported(scene, cfg)
    if reason is not None:
        raise NotImplementedError(reason)
    if cfg.ray_block % 256:
        raise ValueError("the fused pipeline needs ray_block % 256 == 0")
    return scene, FusedPipeline(scene, cfg, device)
