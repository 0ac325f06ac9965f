"""`--tracer residentwalk` end to end: the resident-table walk (K8's plain
version on the CPU) under the general pool against the reference's
(make_walk_tracer in interpret mode under its `_render_pool`), on an 8 x 8
box field under a lamp (tests/test_walkpool.py's lit grid at n = 8),
split-ordered as the CLI orders it, at 16^2, 2 spp, sorted as bench.py's
cfg_sorted. All but 2 of the 256 pixels within 1e-4, the rest by
bench.py's outlier rule (:115-116: at most 8 above 0.35, max 8): one
pixel, whose light sample grazes a box edge, differs by 0.53 over the
brute tracers of both packages as well, and the port's walk gives its
brute tracer's image exactly. The ray counts within 1% + 8
(tests/test_torch_general_pool.py says why). Then the CLI route."""
import numpy as np
import pytest
import torch

from rendertoy3c_tpu.accel.lbvh import split_order_scene as j_split_order
from rendertoy3c_tpu.integrate.config import RenderConfig as JConfig
from rendertoy3c_tpu.integrate.path import render_frame as j_render_frame
from rendertoy3c_tpu.trace.pallas_walk import make_walk_tracer as j_walk
from rendertoy3c_tpu_torch.accel.lbvh import split_order_scene
from rendertoy3c_tpu_torch.integrate.config import RenderConfig
from rendertoy3c_tpu_torch.integrate.path import render_frame
from rendertoy3c_tpu_torch.scene.camera import Camera
from rendertoy3c_tpu_torch.trace import residentwalk
from torch_port_util import lit_grid_scene

KW = dict(width=16, height=16, samples_per_launch=2, max_depth=6,
          ray_block=512, integrator="pool", pool_pixel_major=True,
          sort_rays=True)
CAM = Camera(eye=(3.5, 9.0, 16.0), lookat=(3.5, 0.0, 3.5), fov_y=50.0)


@pytest.fixture(scope="module")
def field():
    return (j_split_order(lit_grid_scene("jax", n=8)),
            split_order_scene(lit_grid_scene("torch", n=8)))


def test_residentwalk_pool_matches_reference(field):
    js, ts = field
    assert ts.num_faces == js.num_faces == 8 * 8 * 12 + 2
    cam = CAM.params()
    f_ref, s_ref = j_render_frame(js, cam, JConfig(**KW), subframes=1,
                                  tracer=j_walk(js, interpret=True))
    walk = residentwalk.make_walk_tracer(ts, "cpu")
    passes = []
    closest = walk[0]

    def counted(o, d, tmin, tmax, time=None, count=None):
        passes.append(int(count))
        return closest(o, d, tmin, tmax, time, count)

    f, s = render_frame(ts, cam, RenderConfig(**KW), subframes=1,
                        tracer=(counted, walk[1]), device="cpu")
    a, b = f.accum.numpy(), np.asarray(f_ref.accum)
    d = np.abs(a - b).max(-1)
    assert (d > 1e-4).sum() <= 2 and (d > 0.35).sum() <= 8
    assert d.max() <= 8.0 and a.mean() > 0.01
    for got, want in ((s.radiance_rays, s_ref.radiance_rays),
                      (s.shadow_rays, s_ref.shadow_rays)):
        assert abs(int(got) - int(want)) <= 0.01 * int(want) + 8
    # the sorted pool hands the walk its live prefix
    assert passes and max(passes) <= 512 and min(passes) < 512


def test_cli_residentwalk_route(tmp_path, monkeypatch):
    """--tracer residentwalk: the split order (256-face runs) and the walk
    tracer, rendered through make_render_fn; leafwalk and bvh exit naming
    their ROADMAP items."""
    from rendertoy3c_tpu_torch.app import cli

    seen = {}
    real = cli.make_render_fn

    def spy(scene, cfg, tracer=None, *, device):
        seen.update(scene=scene, cfg=cfg, tracer=tracer)
        return real(scene, cfg, tracer=tracer, device=device)

    monkeypatch.setattr(cli, "make_render_fn", spy)
    out = tmp_path / "r.png"
    assert cli.main(["--scene", "cornell", "--size", "8x8", "--spp", "1",
                     "--subframes", "1", "--device", "cpu", "--tracer",
                     "residentwalk", "--ray-block", "100", "-o",
                     str(out)]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    closest, any_hit = seen["tracer"]
    assert isinstance(closest.table, residentwalk.WalkTable)
    assert seen["cfg"].integrator == "pool" and seen["cfg"].pool_pixel_major
    for kind, item in (("leafwalk", "A17"), ("bvh", "A24")):
        with pytest.raises(SystemExit, match=item):
            cli.main(["--scene", "cornell", "--device", "cpu", "--tracer",
                      kind, "-o", str(out)])
    assert cli.main(["--scene", "cornell", "--size", "8x8", "--spp", "1",
                     "--subframes", "1", "--device", "cpu", "--tracer",
                     "hierwalk", "--integrator", "wave", "-o",
                     str(out)]) == 0
    assert seen["cfg"].integrator == "wave"
    assert torch.is_tensor(seen["tracer"][0](
        torch.zeros(1, 3), torch.tensor([[0.0, 1.0, 0.0]]), 0.01, 1e16,
        None).t)
