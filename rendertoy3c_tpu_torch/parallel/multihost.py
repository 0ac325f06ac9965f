"""Multi-process rendering across hosts: torch.distributed over the
(tile, spp) mesh.

Port of rendertoy3c_tpu/parallel/multihost.py. The reference joins a JAX
multi-controller job and lets its mesh span every host's devices; here
every process drives one GPU (or the CPU) and the mesh of
parallel/dist.py spans the processes, so one host and many hosts are the
same mechanism: `init_multihost` joins the process group (NCCL on CUDA,
gloo on the CPU) at a `host:port` rendezvous, each rank builds the same
scene and tables, renders its tile band, and `assemble_film` all-gathers
the bands for display or saving.
"""
from __future__ import annotations

import os
from typing import Callable

import torch
import torch.distributed as dist

from ..film.film import Film
from ..integrate.config import RenderConfig
from .dist import Mesh, film_create_sharded, rank_device


def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   device="cuda") -> None:
    """Join the job's process group: `coordinator` is "host:port" of the
    rendezvous (rank 0 listens there), every process passes the same
    address and num_processes, and its own process_id. The backend is
    NCCL for a CUDA device and gloo for the CPU; on CUDA the process's
    GPU becomes the current device."""
    device = torch.device(device)
    if device.type == "cuda":
        n = max(torch.cuda.device_count(), 1)
        local = int(os.environ.get("LOCAL_RANK", process_id % n))
        torch.cuda.set_device(rank_device(torch.device("cuda", local)))
    dist.init_process_group(
        backend="nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id)


def film_create_multihost(cfg: RenderConfig, mesh: Mesh) -> Film:
    """This rank's band of the film (each process holds only its rows, as
    the reference's make_array_from_callback shards)."""
    return film_create_sharded(cfg, mesh)


def assemble_film(accum: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole image [H, W, 3] on every rank, gathered from the tile
    bands (the spp ranks of a band hold the same rows; the first one's
    are taken). Every rank calls it: it is a collective under a process
    group."""
    if mesh.world == 1:
        return accum
    bands = [torch.empty_like(accum) for _ in range(mesh.world)]
    dist.all_gather(bands, accum.contiguous())
    return torch.cat([bands[t * mesh.n_spp] for t in range(mesh.n_tile)])


def make_render_fn_multihost(scene, cfg: RenderConfig, n_spp: int = 1,
                             tracer_kind: str = "auto", device="cuda"
                             ) -> tuple[Callable, Mesh, Film]:
    """The distributed step over every process of the group, with the
    tile axis = world // n_spp: (step, mesh, this rank's film). Every
    process calls it with the same arguments and then drives the step in
    lockstep."""
    from .dist import make_mesh, make_render_fn_dist, prepare_tracer_factory

    mesh = make_mesh(n_spp=n_spp, device=device)
    scene, factory = prepare_tracer_factory(scene, cfg, kind=tracer_kind,
                                            device=mesh.device)
    step, mesh = make_render_fn_dist(scene, cfg, mesh,
                                     tracer_factory=factory)
    return step, mesh, film_create_multihost(cfg, mesh)
