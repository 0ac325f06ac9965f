"""The hierwalk band in the port's tracer ladder, its knobs, its CLI and
what it still refuses.

choose_tracer sends pool scenes of more than 16384 faces, static and
2-key, to the walk pool over their split-ordered faces; tune_config gives
the reference's pool width and flush cadence (tests/test_walkpool.py:296
calls it with on_tpu=True; the port applies it on the CUDA device); the
rounds between boundaries resolve as the reference's _render_pipepool
resolves walk_phase_every (walkpool.py:1037-1054); the CLI renders a
.obj of more than 16384 faces through the walk pool. The classic P = 1
pool and the 32-wide bf16 directories raise NotImplementedError naming
their ROADMAP item; a scene of more than 2 keys takes the bare hierwalk
over the stacked segment tables, and a scene K6 does not shade the walk
pool's general shade stage."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rendertoy3c_tpu.integrate.config import RenderConfig as JConfig
from rendertoy3c_tpu.trace.auto import tune_config as j_tune_config
from rendertoy3c_tpu_torch.integrate import path
from rendertoy3c_tpu_torch.integrate.config import RenderConfig
from rendertoy3c_tpu_torch.integrate.walkpool import (WalkPoolPipeline,
                                                      make_walkpool_pipeline,
                                                      phase_rounds)
from rendertoy3c_tpu_torch.scene.builtin import cornell_box
from rendertoy3c_tpu_torch.scene.scene import build_scene
from rendertoy3c_tpu_torch.trace import hierwalk
from rendertoy3c_tpu_torch.trace.intersect import make_bruteforce_tracer
from rendertoy3c_tpu_torch.trace.auto import (LEAFWALK_MIN_FACES,
                                              choose_tracer, tune_config)
from torch_port_util import lit_grid_scene

POOL = dict(integrator="pool", pool_pixel_major=True, width=16, height=16,
            samples_per_launch=1, max_depth=3, ray_block=1024)


@pytest.fixture(scope="module")
def grid():
    return lit_grid_scene("torch")


def _two_key(scene):
    g = scene.geom
    shift = np.float32([0.2, 0.0, 0.1])
    geom = g._replace(**{k: np.concatenate([getattr(g, k)] * 2)
                         for k in ("e1", "e2", "n0", "n1", "n2")},
                      v0=np.concatenate([g.v0, g.v0 + shift]))
    return dataclasses.replace(scene, geom=geom, num_keys=2)


@pytest.mark.parametrize("motion", [False, True], ids=["static", "2key"])
def test_choose_tracer_takes_the_walk_pool(grid, motion):
    scene = _two_key(grid) if motion else grid
    assert scene.num_faces > LEAFWALK_MIN_FACES
    ordered, pipe = choose_tracer(scene, RenderConfig(**POOL), "cpu")
    assert isinstance(pipe, WalkPoolPipeline)
    assert pipe.motion == motion and pipe.num_faces == ordered.num_faces
    leaf = hierwalk.HIER_LEAF_MOTION if motion else hierwalk.HIER_LEAF
    assert ordered.num_faces % leaf == 0  # the kept variable ordering
    assert pipe.table.n_levels >= 2 and pipe.misc_w == 16
    assert pipe.shadow_w == (16 if motion else 8)


@pytest.mark.parametrize("faces, integrator, device", [
    (19202, "pool", "cuda"), (150_000, "pool", "cuda"),
    (10_000, "pool", "cuda"), (19202, "wave", "cuda"),
    (19202, "pool", "cpu")])
@pytest.mark.parametrize("ray_block, flush_every", [(32768, 0), (4096, 3)])
def test_tune_config_matches_reference(faces, integrator, device, ray_block,
                                       flush_every):
    scene = SimpleNamespace(num_faces=faces, num_keys=1)
    kw = dict(integrator=integrator, ray_block=ray_block,
              flush_every=flush_every, pool_pixel_major=True)
    got = tune_config(scene, RenderConfig(**kw), device)
    want = j_tune_config(scene, JConfig(**kw), on_tpu=device == "cuda")
    assert (got.ray_block, got.flush_every, got.sort_rays) == (
        want.ray_block, want.flush_every, want.sort_rays)


@pytest.mark.parametrize("every, levels, rounds", [
    (0, 3, 16), (0, 5, 16), (0, 6, 32), (5, 3, 5), (7, 6, 7)])
def test_phase_rounds_resolve_as_the_reference(every, levels, rounds):
    assert phase_rounds(RenderConfig(walk_phase_every=every),
                        levels) == rounds


def test_negative_phase_rounds_raise():
    with pytest.raises(ValueError):
        phase_rounds(RenderConfig(walk_phase_every=-1), 3)


@pytest.mark.parametrize("case, item", [
    ("pool_paths_1", "A18"), ("fanout_32", "A17"), ("three_keys", "A5"),
    ("xla_shade_stage", "A22")])
def test_what_the_walk_band_still_refuses(grid, case, item):
    """P = 1 and FANOUT32 raise naming their item; 3 keys (A5, ported)
    take the bare hierwalk over the stacked segment tables, never the walk
    pool; a scene K6 does not shade (here the physical throughput model;
    A22, ported) takes the walk pool with the general shade stage."""
    cfg = RenderConfig(**POOL)
    if case == "xla_shade_stage":
        ordered, pipe = choose_tracer(grid, dataclasses.replace(
            cfg, throughput_model="physical"), "cpu")
        assert isinstance(pipe, WalkPoolPipeline) and not pipe.kernel
        assert pipe.num_faces == ordered.num_faces >= grid.num_faces
        assert choose_tracer(grid, cfg, "cpu")[1].kernel
        return
    if case == "three_keys":
        g = _two_key(grid)
        g = dataclasses.replace(g, num_keys=3, geom=g.geom._replace(
            **{k: np.concatenate([getattr(g.geom, k),
                                  getattr(g.geom, k)[:1]])
               for k in ("v0", "e1", "e2", "n0", "n1", "n2")}))
        ordered, tracer = choose_tracer(g, cfg, "cpu")
        assert isinstance(tracer, tuple) and len(tracer) == 2
        assert ordered.num_keys == 3 and ordered.num_faces >= g.num_faces
        tab = hierwalk.build_hier_table_nkey(ordered.geom, ordered.num_faces,
                                             3)
        assert tab.n_seg == 2 and tab.table.shape[0] == 2 * tab.seg_rows
        rng = np.random.default_rng(3)
        o = torch.tensor(rng.uniform((0, 30, 0), (40, 30, 40), (64, 3)),
                         dtype=torch.float32)
        d = torch.tensor([[0.0, -1.0, 0.0]] * 64)
        tm = torch.tensor(rng.random(64), dtype=torch.float32)
        hit = tracer[0](o, d, 1e-3, 1e16, tm)
        want = make_bruteforce_tracer(ordered)[0](o, d, 1e-3, 1e16, tm)
        assert torch.equal(hit.prim, want.prim) and (hit.prim >= 0).any()
        return
    with pytest.raises(NotImplementedError, match=item):
        if case == "pool_paths_1":
            scene = build_scene(cornell_box()[0])
            pipe = make_walkpool_pipeline(scene, cfg, "cpu")
            path.render_pixels(scene, dataclasses.replace(cfg, pool_paths=1),
                               cornell_box()[1].params(), pipe,
                               np.arange(256), 0)
        else:
            hierwalk.build_hier_table(grid.geom, grid.num_faces,
                                      fanout=hierwalk.FANOUT32)


def test_cli_renders_a_large_obj_through_the_walk_pool(tmp_path,
                                                       monkeypatch):
    from rendertoy3c_tpu_torch.app import cli
    from rendertoy3c_tpu_torch.io.genassets import generate_town

    paths, _ = generate_town(str(tmp_path), faces_target=18000)
    calls = []
    real = path._render_pipepool

    def counted(*args, **kw):
        calls.append(args[3])
        return real(*args, **kw)

    monkeypatch.setattr(path, "_render_pipepool", counted)
    out = tmp_path / "town.png"
    assert cli.main(["--scene", paths[0], "--size", "12x12", "--spp", "1",
                     "--subframes", "1", "--max-depth", "3", "--eye",
                     "38,26,46", "--lookat", "0,1.5,0", "--fov", "42",
                     "--device", "cpu", "-o", str(out)]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert len(calls) == 1 and calls[0].num_faces > LEAFWALK_MIN_FACES
