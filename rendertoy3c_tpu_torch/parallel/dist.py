"""Distributed rendering over a (tile, spp) mesh of processes.

Port of rendertoy3c_tpu/parallel/dist.py on torch.distributed. The
reference shards one jitted subframe over a jax.sharding.Mesh of devices;
here, as PyTorch runs one process per GPU, a device of that mesh is a
rank. Ranks map to (tile, spp) row-major, as `make_mesh` reshapes the
devices (:58-62):

  * "tile": the image's rows are split into n_tile contiguous bands; a
    rank renders its band's pixels `tile_r * shard_pixels +
    arange(shard_pixels)` and keeps the band's film;
  * "spp": the samples_per_launch budget is split over n_spp ranks that
    render the same band with decorrelated streams, subframe n of spp
    rank r seeding with tea(pixel, n * n_spp + r) (:273-283); their
    estimates are averaged by an all_reduce(SUM) over the spp group and a
    division (gloo has no AVG), as the reference's `pmean`.

The ray and round counters are summed over all ranks. The scene and the
tracer's tables are built on every rank from the same inputs
(deterministic builds, as the reference replicates them). The process
group is NCCL for CUDA devices and gloo for the CPU
(parallel/multihost.py `init_multihost`); a single process without a
group is a 1 x 1 mesh. With n_spp == 1 the sharded render is bit-identical
to one device's, as in the reference.

`make_render_fn_dist`'s step splits into `render_shard`, the work of one
rank without collectives, and the collectives, whose arithmetic is
`spp_mean` and `sum_counts`. `render_mesh_in_process` runs every rank's
`render_shard` in one process and combines them through the same two
functions, with in-process sums in place of the collectives.
"""
from __future__ import annotations

import copy
import dataclasses
import os
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..film.film import Film, film_accumulate
from ..integrate.config import RenderConfig
from ..integrate.path import RenderStats, render_pixels
from ..trace.intersect import make_bruteforce_tracer
from ..trace.shade import ExternalPipeline, FusedPipeline


@dataclass
class Mesh:
    """One rank's view of the (tile, spp) mesh: its coordinates, its
    device and, with n_spp > 1 under a process group, the group of the
    ranks that share its tile."""

    n_tile: int
    n_spp: int
    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    spp_group: object = None

    @property
    def shape(self) -> dict:
        return {"tile": self.n_tile, "spp": self.n_spp}

    @property
    def tile_rank(self) -> int:
        return self.rank // self.n_spp

    @property
    def spp_rank(self) -> int:
        return self.rank % self.n_spp


def _world() -> tuple[int, int]:
    """(rank, world size) of the process group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank_device(device) -> torch.device:
    """This rank's device: for CUDA, the GPU of its local rank
    (LOCAL_RANK, else the rank modulo the visible GPUs). Raises when the
    rank finds no GPU; nothing falls back to the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs a GPU on every rank; this rank "
                           "finds none")
    n = torch.cuda.device_count()
    if device.index is not None:
        local = device.index
    else:
        local = int(os.environ.get("LOCAL_RANK", _world()[0] % n))
    if local >= n:
        raise RuntimeError(f"rank's local GPU {local} is not among the {n} "
                           "visible GPUs")
    return torch.device("cuda", local)


def make_mesh(n_tile: Optional[int] = None, n_spp: int = 1,
              device="cuda") -> Mesh:
    """This rank's (tile, spp) mesh over the process group's ranks (one
    rank without a group), on this rank's GPU unless `device` says
    otherwise (rank_device raises where there is none). n_tile defaults to
    world // n_spp (pure tile parallelism, the reference's default). Every
    rank calls it with the same arguments: the spp groups are made
    collectively."""
    rank, world = _world()
    if n_tile is None:
        n_tile = world // n_spp
    mesh = Mesh(n_tile=int(n_tile), n_spp=int(n_spp), rank=rank,
                world=world, device=rank_device(device))
    if world > 1 and n_spp > 1 and n_tile * n_spp == world:
        for t in range(n_tile):
            ranks = list(range(t * n_spp, (t + 1) * n_spp))
            group = dist.new_group(ranks)
            if rank in ranks:
                mesh.spp_group = group
    return mesh


def _bruteforce_factory(scene, aux, cfg: RenderConfig):
    return make_bruteforce_tracer(scene, chunk=cfg.tri_chunk)


def _const(tracer):
    return lambda scene_rep, aux, cfg_local: tracer


def _fused_factory(pipe: FusedPipeline, cfg: RenderConfig):
    """The fused pipeline at a rank's share of the samples. K4's in-kernel
    refill reads the pipeline's samples_per_launch, which the spp axis
    divides: a rank of an n_spp > 1 mesh gets a copy at cfg_local's
    count (the per-sample jump table of the full count holds the share's
    rows first). The reference hands every rank the full-count pipeline,
    whose refill then draws n_spp times the samples."""
    def factory(scene_rep, aux, cfg_local):
        if cfg_local.samples_per_launch == cfg.samples_per_launch:
            return pipe
        local = copy.copy(pipe)
        local.cfg = cfg_local
        return local
    return factory


def prepare_tracer_factory(scene, cfg: RenderConfig, kind: str = "auto", *,
                           device):
    """The scene and a tracer factory for `kind`, routed as the
    reference's prepare_tracer_factory (:75-225); returns (scene,
    factory). The tables are built once here on `device`. The returned
    scene may be re-ordered (Morton or SAH split order) so that prim ids
    match the tables: always render the returned scene. kind: "auto" (the
    ladder below), "fused", "walkpool", "external", "hierwalk", "leafwalk",
    "pallas" (the bare MT pair) or "brute" (the brute pair, built per
    call). An instanced scene takes the trace-time two-level tracers
    whatever the kind: "pallas" (or more than 2 keys) K7's pair
    (trace/instanced_mt.py), else the instanced walk pool, the instanced
    walk under the external pipeline, or the bare instanced walk.

    A scene of more than 2 keys takes "hierwalk" (the stacked segment
    tables) past 16384 faces and "brute" below, as the reference's
    (:152-176). What the port has not ported raises NotImplementedError
    naming its item: the leaf walk (A17)."""
    from ..accel.lbvh import morton_order_scene, split_order_scene
    from ..integrate.walkpool import (LEAFWALK_MIN_FACES,
                                      make_inst_walkpool_pipeline,
                                      make_walkpool_pipeline)
    from ..trace.auto import _eff_faces, _is_instanced
    from ..trace.hier_instanced import (make_inst_hierwalk_tracer,
                                        split_order_instanced)
    from ..trace.hierwalk import (HIER_LEAF, HIER_LEAF_MOTION,
                                  make_hierwalk_tracer)
    from ..trace.mt import make_mt_tracer
    from ..trace.shade import external_unsupported, fused_unsupported

    device = torch.device(device)
    if _is_instanced(scene):
        if scene.num_keys > 2 or kind == "pallas":
            from ..trace.instanced_mt import make_instanced_mt_tracer

            return scene, _const(make_instanced_mt_tracer(scene, device))
        scene = split_order_instanced(scene)
        inst_pool_ok = cfg.integrator == "pool" and cfg.ray_block % 256 == 0
        if (kind == "walkpool"
                or (kind == "auto" and inst_pool_ok
                    and _eff_faces(scene) > LEAFWALK_MIN_FACES)):
            tracer = make_inst_walkpool_pipeline(scene, cfg, device)
        else:
            tracer = make_inst_hierwalk_tracer(scene, device)
            if (kind in ("auto", "external") and inst_pool_ok
                    and external_unsupported(scene, cfg) is None):
                tracer = ExternalPipeline(scene, cfg, tracer, device)
        return scene, _const(tracer)

    no_inst = getattr(scene, "instances", None) is None
    pool_ok = cfg.integrator == "pool" and cfg.ray_block % 256 == 0 \
        and no_inst
    big = scene.num_faces > LEAFWALK_MIN_FACES
    large = scene.num_keys <= 2 and big
    if kind == "auto":
        if large:
            if cfg.integrator == "pool" and no_inst:
                kind = "walkpool"
            else:
                kind = ("external" if pool_ok
                        and external_unsupported(scene, cfg) is None
                        else "leafwalk")
        elif big:
            kind = "hierwalk"
        elif pool_ok and fused_unsupported(scene, cfg) is None:
            kind = "fused"
        elif pool_ok and external_unsupported(scene, cfg) is None:
            kind = "external"
        elif scene.num_keys <= 2:
            kind = "pallas"
        else:
            kind = "brute"

    if kind == "brute":
        return scene, _bruteforce_factory
    leaf = HIER_LEAF if scene.num_keys == 1 else HIER_LEAF_MOTION
    if kind == "walkpool":
        scene = split_order_scene(scene, leaf=leaf)
        return scene, _const(make_walkpool_pipeline(scene, cfg, device))
    pair = None
    if kind == "leafwalk" and scene.num_keys == 1:
        raise NotImplementedError(
            "the per-ray leaf walk (kind='leafwalk') is not ported yet "
            "(ROADMAP A17)")
    if kind == "hierwalk" or (kind == "external" and large):
        scene = split_order_scene(scene, leaf=leaf)
        pair = make_hierwalk_tracer(scene, device)
    else:
        if scene.num_faces > 512 and scene.num_keys == 1:
            scene = morton_order_scene(scene)
        if kind != "fused":
            pair = make_mt_tracer(scene, device)
    if kind == "fused":
        return scene, _fused_factory(FusedPipeline(scene, cfg, device), cfg)
    if kind == "external":
        tracer = ExternalPipeline(scene, cfg, pair, device)
    else:
        tracer = pair
    return scene, _const(tracer)


def render_shard(scene, cfg: RenderConfig, mesh: Mesh, tracer, cam,
                 subframe_index: int, tile_r: int, spp_r: int):
    """The work of rank (tile_r, spp_r) for one subframe, before the
    collectives (:273-283): the band's pixels at sub-frame index
    subframe_index * n_spp + spp_r with samples_per_launch // n_spp
    samples. Returns (rgb [rows, W, 3], AOV pair [rows, W, 3] each or
    None, radiance rays, shadow rays, rounds)."""
    cfg_local = dataclasses.replace(
        cfg, samples_per_launch=cfg.samples_per_launch // mesh.n_spp)
    rows = cfg.height // mesh.n_tile
    shard_pixels = rows * cfg.width
    pix = tile_r * shard_pixels + torch.arange(shard_pixels,
                                               dtype=torch.int64)
    sub_eff = subframe_index * mesh.n_spp + spp_r
    rgb, aov, n_rad, n_shad, n_round = render_pixels(
        scene, cfg_local, cam, tracer, pix, sub_eff, device=mesh.device)
    shape = (rows, cfg.width, 3)
    aov = None if aov is None else tuple(a.reshape(shape) for a in aov)
    return rgb.reshape(shape), aov, n_rad, n_shad, n_round


def spp_mean(rgb, aov, n_spp: int, sum_spp: Callable):
    """The spp axis' mean of one rank's estimates (rgb and the AOV pair or
    None), as the reference's pmean: sum_spp(k, buf) sums buffer k (rgb,
    albedo, normal) in place over the ranks of the rank's tile band (an
    all_reduce(SUM) over its spp group), then a division by n_spp (gloo
    has no AVG). Returns (rgb, aov); n_spp == 1 returns them as they
    are."""
    if n_spp == 1:
        return rgb, aov
    bufs = [rgb] + list(aov or ())
    for k, b in enumerate(bufs):
        sum_spp(k, b)
    div = torch.tensor(float(n_spp), device=rgb.device)
    rgb, *rest = [b / div for b in bufs]
    return rgb, (tuple(rest) if aov is not None else None)


def sum_counts(n_rad, n_shad, n_round, device, sum_all: Callable):
    """The ray and round counters of one rank summed over every rank:
    sum_all(counts) sums the int64 [3] tensor in place (an
    all_reduce(SUM) over the group). Returns (radiance rays, shadow rays,
    rounds) as ints."""
    counts = torch.tensor([int(n_rad), int(n_shad), int(n_round)],
                          dtype=torch.int64, device=device)
    sum_all(counts)
    return tuple(counts.cpu().tolist())


def render_mesh_in_process(scene, cfg: RenderConfig, n_tile: int,
                           n_spp: int, tracer, cam, subframe_index: int,
                           device):
    """Every rank's `render_shard` of one subframe in this process,
    combined by `spp_mean` and `sum_counts` as the step combines them,
    the collectives' sums taken in rank order. Returns (the whole image
    [H, W, 3], the AOV pair or None, radiance rays, shadow rays, rounds).
    It checks a decomposition on one device; with n_spp > 2 a collective
    may sum in another order."""
    mesh = Mesh(n_tile=n_tile, n_spp=n_spp, device=torch.device(device))
    shards = [[render_shard(scene, cfg, mesh, tracer, cam, subframe_index,
                            t, s) for s in range(n_spp)]
              for t in range(n_tile)]
    bands, aov_bands = [], []
    for band in shards:
        others = [[rgb] + list(aov or ()) for rgb, aov, *_ in band[1:]]

        def add_others(k, buf, others=others):
            for bufs in others:
                buf.add_(bufs[k])

        rgb, aov = spp_mean(band[0][0], band[0][1], n_spp, add_others)
        bands.append(rgb)
        aov_bands.append(aov)
    counts = [shard[2:] for band in shards for shard in band]

    def add_ranks(total):
        for cnt in counts[1:]:
            total += torch.tensor([int(x) for x in cnt], dtype=torch.int64)

    sums = sum_counts(*counts[0], "cpu", add_ranks)
    aov = (tuple(torch.cat(b) for b in zip(*aov_bands))
           if aov_bands[0] is not None else None)
    return (torch.cat(bands), aov, *sums)


def make_render_fn_dist(scene, cfg: RenderConfig, mesh: Mesh,
                        tracer_factory: Callable = None,
                        tracer_aux=None):
    """The distributed subframe step step(cam, film) -> (film, stats) of
    this rank, with the mesh: (step, mesh). The film is this rank's band
    (film_create_sharded) and stays on the rank's device; the stats are
    summed over all ranks. Every rank calls the step in lockstep.

    Raises ValueError when the height does not divide by the tile axis or
    samples_per_launch by the spp axis (:247-255), or when the mesh does
    not cover the process group's ranks."""
    if tracer_factory is None:
        tracer_factory = _bruteforce_factory
    n_tile, n_spp = mesh.n_tile, mesh.n_spp
    if cfg.height % n_tile:
        raise ValueError(
            f"height {cfg.height} not divisible by tile axis {n_tile}")
    if cfg.samples_per_launch % n_spp:
        raise ValueError(
            f"samples_per_launch {cfg.samples_per_launch} not divisible by "
            f"spp axis {n_spp}")
    if n_tile * n_spp != mesh.world:
        raise ValueError(
            f"a {n_tile} x {n_spp} mesh needs {n_tile * n_spp} ranks; the "
            f"process group has {mesh.world}")
    cfg_local = dataclasses.replace(
        cfg, samples_per_launch=cfg.samples_per_launch // n_spp)
    tracer = tracer_factory(scene, tracer_aux, cfg_local)
    # render_pixels' fifth output: pool iterations for the megakernel
    # pipelines, walk rounds otherwise (:294-303)
    round_field = ("pool_iters" if isinstance(
        tracer, (FusedPipeline, ExternalPipeline)) else "walk_rounds")
    grouped = dist.is_available() and dist.is_initialized()

    def sum_spp(k, buf):
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.spp_group)

    def sum_all(counts):
        if grouped:
            dist.all_reduce(counts, op=dist.ReduceOp.SUM)

    def step(cam, film: Film):
        rgb, aov, n_rad, n_shad, n_round = render_shard(
            scene, cfg, mesh, tracer, cam, film.subframe_index,
            mesh.tile_rank, mesh.spp_rank)
        rgb, aov = spp_mean(rgb, aov, n_spp, sum_spp)
        n_rad, n_shad, n_round = sum_counts(n_rad, n_shad, n_round,
                                            mesh.device, sum_all)
        film = film_accumulate(film, rgb, aov=aov)
        return film, RenderStats(radiance_rays=torch.tensor(n_rad),
                                 shadow_rays=torch.tensor(n_shad),
                                 **{round_field: n_round})

    return step, mesh


def film_create_sharded(cfg: RenderConfig, mesh: Mesh) -> Film:
    """This rank's film: the rows of its tile band, [H / n_tile, W, 3] on
    its device (row 0 the band's bottom row, as the image's)."""
    rows = cfg.height // mesh.n_tile

    def img():
        return torch.zeros((rows, cfg.width, 3), dtype=torch.float32,
                           device=mesh.device)

    return Film(accum=img(), albedo=img() if cfg.aov else None,
                normal=img() if cfg.aov else None)


def render_distributed(scene, cam, cfg: RenderConfig,
                       mesh: Optional[Mesh] = None, subframes: int = 1,
                       tracer_factory: Callable = None, tracer_aux=None):
    """Offline distributed progressive render. Returns (this rank's film,
    total stats over all ranks)."""
    if mesh is None:
        mesh = make_mesh()
    step, mesh = make_render_fn_dist(scene, cfg, mesh,
                                     tracer_factory=tracer_factory,
                                     tracer_aux=tracer_aux)
    film = film_create_sharded(cfg, mesh)
    total_rad = 0
    total_shad = 0
    for _ in range(subframes):
        film, stats = step(cam, film)
        total_rad += int(stats.radiance_rays)
        total_shad += int(stats.shadow_rays)
    return film, RenderStats(radiance_rays=torch.tensor(total_rad),
                             shadow_rays=torch.tensor(total_shad))
