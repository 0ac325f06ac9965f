"""Tracer choice for the path renderer.

Port of rendertoy3c_tpu/trace/auto.py `choose_tracer` (:98-195), narrowed
to the ported rungs of its ladder and never routing a scene elsewhere
than the reference would:

  static scene of more than 512 faces -> Morton face order first (:183-188)
  up to 2048 faces, static or 2-key   -> FusedPipeline (the megakernels)
  2049-16384 faces, static or 2-key   -> make_mt_tracer + ExternalPipeline

2-key scenes keep their face order, as in the reference. Everything else
raises NotImplementedError naming the ROADMAP item that adds it: more
than 16384 faces (the hierwalk band) and more than 2 keys.
Returns (scene, tracer): always render the returned scene, whose face
order matches the tracer's tables.
"""
from __future__ import annotations

from ..accel.lbvh import morton_order_scene
from .mt import make_mt_tracer
from .shade import (EXTERNAL_MAX_FACES, MAX_FACES, ExternalPipeline,
                    FusedPipeline, external_unsupported, fused_unsupported)


def choose_tracer(scene, cfg, device):
    """(scene, tracer) for rendering `scene` under `cfg` on `device`."""
    if scene.num_faces > EXTERNAL_MAX_FACES:
        raise NotImplementedError(
            f"scenes of more than {EXTERNAL_MAX_FACES} faces take the "
            "hierwalk band and its walk pool (ROADMAP A17/A18)")
    if scene.num_keys > 2:
        raise NotImplementedError(
            "more than 2 motion keys need the N-key brute tracer "
            "(ROADMAP A5)")
    if cfg.ray_block % 256:
        raise ValueError("the pool pipelines need ray_block % 256 == 0")
    if scene.num_faces > 512 and scene.num_keys == 1:
        # spatially coherent face order tightens the per-tile cull boxes
        # (before the tracer build, so prim ids match the tables)
        scene = morton_order_scene(scene)
    if scene.num_faces <= MAX_FACES:
        reason = fused_unsupported(scene, cfg)
        if reason is not None:
            raise NotImplementedError(reason)
        return scene, FusedPipeline(scene, cfg, device)
    reason = external_unsupported(scene, cfg)
    if reason is not None:
        raise NotImplementedError(reason)
    return scene, ExternalPipeline(scene, cfg, make_mt_tracer(scene, device),
                                   device)
