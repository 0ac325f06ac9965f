"""K6's inputs for the tests of its lanes (tests/test_torch_k6_lanes.py
on the CPU, tests/test_torch_cuda.py on the card): a second-bounce pool
state of `n` lanes on a small scene of each variant K6 takes, with the
tables and config the walk pool builds for that scene. Made from a seed
with numpy; the closest hits from the port's brute tracers. Imports
nothing of JAX, so that the card's tests can use it."""
import dataclasses
import functools

import numpy as np
import torch

from rendertoy3c_tpu_torch.integrate.config import RenderConfig
from rendertoy3c_tpu_torch.integrate.walkpool import _shade_stage
from rendertoy3c_tpu_torch.trace import shade

torch.set_num_threads(1)  # as tests/torch_port_util.py, for pytest-xdist

# untextured Cornell, its 2-key form (shadow rays with their time), the
# textured quad with clamp and mirror wraps, a uv transform and a normal
# map, the material Cornell box with the power pick, Cornell with AOV,
# the trace-time instanced Cornell of multi_instance_tracetime (instance
# rows) and the normal-mapped quad under a rotated, scaled instance (the
# tangent's transform)
VARIANTS = ("untextured", "motion", "textured", "dispatch_power", "aov",
            "inst", "inst_normal_map")


@functools.lru_cache(maxsize=None)
def scene_of(variant: str):
    """(scene, camera, cfg) of a variant."""
    from rendertoy3c_tpu_torch.scene.builtin import (cornell_box,
                                                      instanced_bumpy_quad,
                                                      material_cornell_box,
                                                      multi_instance_cornell,
                                                      textured_quad_variant)
    from rendertoy3c_tpu_torch.scene.instanced import build_instanced_scene
    from rendertoy3c_tpu_torch.scene.scene import build_scene

    cfg = RenderConfig(integrator="pool", aov=variant == "aov",
                       light_sampler="power" if variant == "dispatch_power"
                       else "uniform")
    if variant == "textured":
        meshes, textures, cam = textured_quad_variant("features")
        return build_scene(meshes, textures=textures), cam, cfg
    if variant == "dispatch_power":
        meshes, cam = material_cornell_box()
        return build_scene(meshes), cam, cfg
    if variant == "inst":
        meshes, inst, cam = multi_instance_cornell()
        return build_instanced_scene(meshes, inst), cam, cfg
    if variant == "inst_normal_map":
        meshes, inst, tex, cam = instanced_bumpy_quad()
        return build_instanced_scene(meshes, inst, textures=tex), cam, cfg
    meshes, cam = cornell_box()
    if variant == "motion":  # the tall block given a second key at +0.1 x
        v = meshes[-1].vertices
        meshes[-1] = dataclasses.replace(meshes[-1], vertices=np.concatenate(
            [v, v + np.float32([0.1, 0, 0])]))
    return build_scene(meshes), cam, cfg


def _fresh(cam, n, rng, mw):
    """Camera rays and fresh paths: random seeds, 90% of the lanes alive,
    the AOV accs random."""
    p = cam.params()
    xy = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    d = xy[:, :1] * p.u + xy[:, 1:] * p.v + p.w
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    rays = np.zeros((n, 8), np.float32)
    rays[:, 0:3], rays[:, 3:6] = p.eye, d
    rays[:, 6], rays[:, 7] = 0.01, 1e16
    misc = np.zeros((n, mw), np.float32)
    misc[:, 0] = rng.integers(0, 2**32, n, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    misc[:, 1:7] = 1.0
    misc[:, 9] = (rng.uniform(size=n) < 0.9).astype(np.float32)
    misc[:, 13] = np.arange(n)
    misc[:, 14] = 1.0
    misc[:, 16:] = rng.uniform(0, 1, (n, mw - 16))
    return rays, misc


def _hits(scene, rays, time, inst: bool):
    """(hit4 [R, 4], instance ids [R] int32 or None) of the closest hits."""
    from rendertoy3c_tpu_torch.trace.instanced import make_instanced_tracer
    from rendertoy3c_tpu_torch.trace.intersect import \
        trace_closest_bruteforce

    o, d = rays[:, 0:3], rays[:, 3:6]
    if inst:
        hit = make_instanced_tracer(scene, rays.device)[0](
            o, d, rays[:, 6], rays[:, 7], time)
    else:
        hit = trace_closest_bruteforce(scene, o, d, rays[:, 6], rays[:, 7],
                                       time=time)
    hit4 = torch.stack([hit.t, hit.prim.to(torch.float32), hit.u, hit.v], 1)
    return hit4, hit.inst.to(torch.int32) if inst else None


def k6_case(variant: str, n: int, seed: int = 0, device="cpu"):
    """(rays, hit4, misc [n, MW] row-major, tables, config, inst) of `n`
    lanes one bounce into their paths (the plain K6 applied once to fresh
    camera lanes, its NEE added, dead lanes restarted)."""
    scene, cam, cfg = scene_of(variant)
    dev = torch.device(device)
    tables, config = _shade_stage(scene, cfg, dev)
    inst = variant.startswith("inst")
    mw = shade.misc_width(cfg.aov)
    rng = np.random.default_rng(seed)
    rays, misc = (torch.as_tensor(x, device=dev) for x in _fresh(
        cam, n, rng, mw))
    time = (torch.as_tensor(rng.uniform(0, 1, n).astype(np.float32),
                            device=dev) if config.motion else None)
    hit4, ids = _hits(scene, rays, time, inst)
    r2, m2, _ = shade.external_shade_ref(rays, hit4, misc, tables, config,
                                         inst=ids)
    m2 = torch.cat([m2[:, :10], m2[:, 10:13] + m2[:, mw:mw + 3],
                    m2[:, 13:mw]], dim=1)
    fr, fm = (torch.as_tensor(x, device=dev) for x in _fresh(cam, n, rng,
                                                             mw))
    dead = (m2[:, 9] <= 0)[:, None]
    rays, misc = torch.where(dead, fr, r2), torch.where(dead, fm, m2)
    hit4, ids = _hits(scene, rays, time, inst)
    return rays, hit4, misc, tables, config, ids
