"""Rendering over a (tile, spp) mesh of processes (torch.distributed)."""
from .dist import (Mesh, film_create_sharded, make_mesh, make_render_fn_dist,
                   prepare_tracer_factory, render_distributed)
from .multihost import (assemble_film, film_create_multihost, init_multihost,
                        make_render_fn_multihost)

__all__ = ["Mesh", "assemble_film", "film_create_multihost",
           "film_create_sharded", "init_multihost", "make_mesh",
           "make_render_fn_dist", "make_render_fn_multihost",
           "prepare_tracer_factory", "render_distributed"]
