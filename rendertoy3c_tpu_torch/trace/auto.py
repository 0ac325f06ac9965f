"""Tracer choice for the path renderer.

Port of rendertoy3c_tpu/trace/auto.py `choose_tracer` (:98-195) and
`tune_config` (:46-90), never routing a scene elsewhere than the
reference would:

  trace-time instanced scene (InstancedScene) of at most 2 keys
                                      -> split_order_instanced, then
                                         (:117-148) the pool with a
                                         ray_block multiple of 256: more
                                         than 16384 effective faces the
                                         instanced walk pool (a static
                                         field on its baked world table),
                                         else the instanced walk +
                                         ExternalPipeline when K6 shades
                                         the scene; otherwise the bare
                                         instanced walk tracer
  more than 16384 faces, static or 2-key
                                      -> SAH split order (leaf 14, or 7
                                         for 2 keys), then the walk pool
                                         (integrate/walkpool.py) under the
                                         pool integrator (K6 shading,
                                         or the general shade stage
                                         where K6 does not shade the
                                         scene), the bare hierwalk
                                         tracer under the wave
                                         integrator (:157-181)
  static scene of more than 512 faces -> Morton face order first (:183-188)
  up to 16384 faces, static or 2-key, the pool with a ray_block multiple
  of 256, shaded by the kernels      -> FusedPipeline (the megakernels) up
                                         to 2048 faces, else the bare MT
                                         tracer (make_mt_tracer) +
                                         ExternalPipeline
  up to 16384 faces otherwise        -> the bare MT tracer (:190-195)
  more than 2 keys (piecewise-linear vertex motion), not instanced:
    more than 16384 faces             -> SAH split order (leaf 7), then
                                         the bare hierwalk tracer over the
                                         stacked segment tables (K9 with
                                         segment offsets) under the
                                         general pool or the wave
                                         integrator (:160-181); never the
                                         walk pool or K6, which take 1 or 2
                                         keys (pallas_shade.py:1118, 1465)
    up to 16384 faces                 -> the brute tracer: the route of
                                         the reference's render when its
                                         ladder offers no tracer
                                         (integrate/path.py:1472-1488) and
                                         of its parallel/dist.py:175-176;
                                         its TPU ladder itself raises here
                                         (make_pallas_mt_tracer's
                                         ValueError, ROADMAP C11)

A bare (closest, any) tracer renders under the general pool or the wave
integrator (integrate/path.py `_render_pool`, `_trace_block`), whose
shading (`_shade_and_nee`) covers the scenes the kernels refuse
(trace/shade.py shading_checks): environment maps, emissive and
roughness textures, normal maps without images, the physical throughput
model, scenes without lights. Past 16384 (effective) faces the walk pool
shades such scenes in its general stage (integrate/walkpool.py
general_shade, `WalkPoolPipeline.kernel` False), the same shading on its
lanes, as the reference's XLA stage does. Motion scenes of the MT band
keep their face order, as in the reference. What stays out raises
NotImplementedError naming the ROADMAP item that adds it: instanced
scenes of more than 2 keys (C1). Returns (scene, tracer): always render
the returned scene, whose face order matches the tracer's tables.
"""
from __future__ import annotations

import dataclasses

import torch

from ..accel.lbvh import morton_order_scene, split_order_scene
from ..integrate.walkpool import (LEAFWALK_MIN_FACES,
                                  make_inst_walkpool_pipeline,
                                  make_walkpool_pipeline)
from .hier_instanced import (baked_world_eligible, make_inst_hierwalk_tracer,
                             split_order_instanced)
from .hierwalk import HIER_LEAF, HIER_LEAF_MOTION, make_hierwalk_tracer
from .intersect import make_bruteforce_tracer
from .mt import make_mt_tracer
from .shade import (ExternalPipeline, FusedPipeline, external_unsupported,
                    fused_unsupported)

# the walk pool's width above 100000 faces (twice it below)
POOL_BLOCK_LARGE = 8192


def _is_instanced(scene) -> bool:
    """True for a trace-time instanced scene (InstancedScene)."""
    return hasattr(scene, "instance_mesh")


def _eff_faces(iscene) -> int:
    """Every instance's (padded) mesh faces: the instanced walk's load."""
    return sum(iscene.mesh_ranges[m][1] for m in iscene.instance_mesh)


def tune_config(scene, cfg, device):
    """The pool knobs the reference applies on its accelerator and the
    port on the CUDA device (`device` of type cuda), for the pool
    integrator; any other (scene, cfg, device) keeps its cfg. Apply it
    before choose_tracer.

    An instanced scene of at most 2 keys: no ray sort, flush cadence 8, a
    pool of 2 * POOL_BLOCK_LARGE lanes for a baked field of more than
    LEAFWALK_MIN_FACES effective faces and POOL_BLOCK_LARGE otherwise.
    Other scenes of more than LEAFWALK_MIN_FACES faces: flush cadence 8,
    a pool of 2 * POOL_BLOCK_LARGE lanes below 100000 faces and
    POOL_BLOCK_LARGE above."""
    if torch.device(device).type != "cuda" or cfg.integrator != "pool":
        return cfg
    if _is_instanced(scene):
        if scene.num_keys > 2:
            return cfg
        wide = (baked_world_eligible(scene)
                and _eff_faces(scene) > LEAFWALK_MIN_FACES)
        return dataclasses.replace(
            cfg,
            ray_block=min(cfg.ray_block,
                          2 * POOL_BLOCK_LARGE if wide else POOL_BLOCK_LARGE),
            sort_rays=False, flush_every=cfg.flush_every or 8)
    if scene.num_faces <= LEAFWALK_MIN_FACES:
        return cfg
    wide = scene.num_faces < 100_000
    return dataclasses.replace(
        cfg,
        ray_block=min(cfg.ray_block,
                      2 * POOL_BLOCK_LARGE if wide else POOL_BLOCK_LARGE),
        flush_every=cfg.flush_every or 8)


def _pipeline_ok(cfg) -> bool:
    """The pipelines take the pool integrator with a ray_block multiple of
    256 (auto.py:154-156)."""
    return cfg.integrator == "pool" and cfg.ray_block % 256 == 0


def choose_tracer(scene, cfg, device):
    """(scene, tracer) for rendering `scene` under `cfg` on `device`."""
    if _is_instanced(scene):
        return _choose_instanced(scene, cfg, device)
    if scene.num_keys > 2:
        if scene.num_faces > LEAFWALK_MIN_FACES:
            scene = split_order_scene(scene, leaf=HIER_LEAF_MOTION)
            return scene, make_hierwalk_tracer(scene, device)
        return scene, make_bruteforce_tracer(scene, chunk=cfg.tri_chunk)
    if scene.num_faces > LEAFWALK_MIN_FACES:
        leaf = HIER_LEAF if scene.num_keys == 1 else HIER_LEAF_MOTION
        scene = split_order_scene(scene, leaf=leaf)
        if cfg.integrator == "pool":
            return scene, make_walkpool_pipeline(scene, cfg, device)
        return scene, make_hierwalk_tracer(scene, device)
    if scene.num_faces > 512 and scene.num_keys == 1:
        # spatially coherent face order tightens the per-tile cull boxes
        # (before the tracer build, so prim ids match the tables)
        scene = morton_order_scene(scene)
    if _pipeline_ok(cfg) and fused_unsupported(scene, cfg) is None:
        return scene, FusedPipeline(scene, cfg, device)
    tracer = make_mt_tracer(scene, device)
    if _pipeline_ok(cfg) and external_unsupported(scene, cfg) is None:
        return scene, ExternalPipeline(scene, cfg, tracer, device)
    return scene, tracer


def _choose_instanced(iscene, cfg, device):
    """The instanced branch of choose_tracer (auto.py:117-150)."""
    if iscene.num_keys > 2:
        raise NotImplementedError(
            "instanced scenes of more than 2 transform keys are refused: "
            "the reference sends them to the two-level kernels (K7, "
            "trace/instanced_mt.py), which take static scenes only "
            "(ROADMAP C1)")
    iscene = split_order_instanced(iscene)
    if _pipeline_ok(cfg) and _eff_faces(iscene) > LEAFWALK_MIN_FACES:
        return iscene, make_inst_walkpool_pipeline(iscene, cfg, device)
    tracer = make_inst_hierwalk_tracer(iscene, device)
    if _pipeline_ok(cfg) and external_unsupported(iscene, cfg) is None:
        return iscene, ExternalPipeline(iscene, cfg, tracer, device)
    return iscene, tracer
