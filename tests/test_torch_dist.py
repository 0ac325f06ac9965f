"""The port's (tile, spp) mesh (parallel/dist.py) on the CPU, against one
device and against the reference's make_render_fn_dist on the
conftest's 8-device CPU mesh (tests/test_dist.py's analogs).

A decomposition runs in one process through `render_mesh_in_process`,
every rank's `render_shard` in turn, combined by the step's own
`spp_mean` and `sum_counts`; tests/test_torch_multihost.py runs the step
over two and four gloo processes.
Tile-sharded renders (8 x 1) are bit-identical to one device's over the
same tracer, for every kind routed here: the brute and MT pairs, the
hierwalk pair and the instanced walk (wave integrator), the fused,
external and walk pools and K7's pair (pool). Against the reference's
sharded render over its own backend of the same kind: at least 98% of the
pixels within rtol = atol = 3e-5 and the means within 5e-3 (the rule of
tests/test_dist.py's pool cases), the radiance rays within MAX_RAY_DIFF
(tests/test_torch_general_pool.py's bound: XLA's CPU backend contracts
a + b * c into fused multiply-adds). (1, 2) and (2, 2) meshes agree with
one device in the mean within 5% (test_tile_spp_mesh_statistics's rule),
the fused pipeline's too, whose spp ranks get it at their share of the
samples; the validation errors. The routing of every kind is in
tests/test_torch_dist_routing.py."""
import numpy as np
import pytest
import torch

from inst_util import to_port_iscene
from rendertoy3c_tpu.integrate.config import RenderConfig as JConfig
from rendertoy3c_tpu.parallel import dist as jdist
from rendertoy3c_tpu_torch.film.film import film_accumulate, film_create
from rendertoy3c_tpu_torch.integrate.config import RenderConfig
from rendertoy3c_tpu_torch.integrate.path import render_frame
from rendertoy3c_tpu_torch.parallel import dist
from torch_port_util import cornell_pair

MAX_RAY_DIFF = 12


def _cfg(**kw):
    base = dict(width=32, height=32, samples_per_launch=2, max_depth=3,
                ray_block=256)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def cornell():
    js, ts, jcam, tcam = cornell_pair()
    jcam.aspect_ratio = tcam.aspect_ratio = 1.0
    return js, ts, jcam, tcam


@pytest.fixture(scope="module")
def inst_cornell():
    from rendertoy3c_tpu.scene.builtin import instanced_cornell
    from rendertoy3c_tpu.scene.instanced import build_instanced_scene

    meshes, instances, camera = instanced_cornell()
    js = build_instanced_scene(meshes, instances)
    camera.aspect_ratio = 1.0
    from rendertoy3c_tpu_torch.scene.camera import Camera

    tcam = Camera(eye=tuple(camera.eye), lookat=tuple(camera.lookat),
                  fov_y=camera.fov_y, aspect_ratio=1.0)
    return js, to_port_iscene(js), camera, tcam


def mesh_render(scene, cfg, n_tile, n_spp, tracer, cam, subframes):
    """The mesh's progressive render in this process: (image, radiance
    rays, shadow rays) summed over the subframes."""
    film = film_create(cfg.height, cfg.width, device="cpu", aov=cfg.aov)
    rad = shad = 0
    for k in range(subframes):
        rgb, aov, n_rad, n_shad, _ = dist.render_mesh_in_process(
            scene, cfg, n_tile, n_spp, tracer, cam, k, "cpu")
        film = film_accumulate(film, rgb, aov=aov)
        rad, shad = rad + n_rad, shad + n_shad
    return film, rad, shad


def j_mesh_render(js, jcfg, jcam, jfac, n_tile, n_spp, subframes):
    mesh = jdist.make_mesh(n_tile=n_tile, n_spp=n_spp)
    step, mesh = jdist.make_render_fn_dist(js, jcfg, mesh,
                                           tracer_factory=jfac)
    film = jdist.film_create_sharded(jcfg, mesh)
    rad = 0
    for _ in range(subframes):
        film, stats = step(jcam.params(), film)
        rad += int(stats.radiance_rays)
    return np.asarray(film.accum), rad


def _near(a, b):
    close = np.isclose(a, b, rtol=3e-5, atol=3e-5)
    assert close.mean() > 0.98, close.mean()
    np.testing.assert_allclose(a.mean(), b.mean(), rtol=5e-3)


# kind, integrator, subframes
KINDS = {
    "brute": ("brute", "wave", 2),
    "pallas": ("pallas", "wave", 1),
    "hierwalk": ("hierwalk", "wave", 1),
    "fused": ("auto", "pool", 1),
    "external": ("external", "pool", 1),
    "walkpool": ("walkpool", "pool", 1),
}


@pytest.mark.parametrize("name", sorted(KINDS))
def test_tile_sharded_bit_identical_and_matches_reference(cornell, name):
    js, ts, jcam, tcam = cornell
    kind, integrator, subframes = KINDS[name]
    kw = _cfg(integrator=integrator)
    cfg = RenderConfig(**kw)
    scene, fac = dist.prepare_tracer_factory(ts, cfg, kind, device="cpu")
    tracer = fac(scene, None, cfg)
    one, s_one = render_frame(scene, tcam.params(), cfg, subframes=subframes,
                              tracer=tracer, device="cpu")
    film, rad, shad = mesh_render(scene, cfg, 8, 1, tracer, tcam.params(),
                                  subframes)
    assert torch.equal(film.accum.view(torch.int32),
                       one.accum.view(torch.int32))
    assert rad == int(s_one.radiance_rays)
    assert shad == int(s_one.shadow_rays)
    jcfg = JConfig(**kw)
    js2, jfac = jdist.prepare_tracer_factory(js, jcfg, kind)
    want, j_rad = j_mesh_render(js2, jcfg, jcam, jfac, 8, 1, subframes)
    _near(film.accum.numpy(), want)
    assert abs(rad - j_rad) <= MAX_RAY_DIFF


@pytest.mark.parametrize("kind", ["auto", "pallas"])
def test_instanced_routes_shard_bit_identically(inst_cornell, kind):
    """The instanced Cornell box: auto takes the bare instanced walk
    (wave), kind="pallas" K7's pair (pool); 8 x 1 bit-identical to one
    device and near the reference's sharded render."""
    js, ts, jcam, tcam = inst_cornell
    kw = _cfg(integrator="wave" if kind == "auto" else "pool",
              ray_block=512)
    cfg = RenderConfig(**kw)
    scene, fac = dist.prepare_tracer_factory(ts, cfg, kind, device="cpu")
    tracer = fac(scene, None, cfg)
    assert isinstance(tracer, tuple)
    if kind == "pallas":
        assert tracer[0].soup.table.shape[0] == ts.num_instances
    one, s_one = render_frame(scene, tcam.params(), cfg, tracer=tracer,
                              device="cpu")
    film, rad, _ = mesh_render(scene, cfg, 8, 1, tracer, tcam.params(), 1)
    assert torch.equal(film.accum.view(torch.int32),
                       one.accum.view(torch.int32))
    assert rad == int(s_one.radiance_rays)
    jcfg = JConfig(**kw)
    js2, jfac = jdist.prepare_tracer_factory(js, jcfg, kind, interpret=True)
    want, j_rad = j_mesh_render(js2, jcfg, jcam, jfac, 8, 1, 1)
    _near(film.accum.numpy(), want)
    assert abs(rad - j_rad) <= MAX_RAY_DIFF


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_tile_spp_mesh_statistics(cornell, shape):
    _, ts, _, tcam = cornell
    cfg = RenderConfig(**_cfg(samples_per_launch=4))
    film, rad, shad = mesh_render(ts, cfg, *shape, None, tcam.params(), 1)
    ref, _ = render_frame(ts, tcam.params(), cfg, device="cpu")
    a, b = film.accum.numpy(), ref.accum.numpy()
    assert np.all(np.isfinite(a)) and rad > 0 and shad > 0
    assert abs(a.mean() - b.mean()) < 0.05 * max(b.mean(), 1e-6)
    # the spp ranks draw other samples than one device's
    assert not np.array_equal(a, b)


def test_mesh_shape_validation(cornell):
    _, ts, _, _ = cornell
    with pytest.raises(ValueError, match="height 36"):
        dist.make_render_fn_dist(ts, RenderConfig(**_cfg(height=36)),
                                 dist.Mesh(n_tile=8, n_spp=1, world=8))
    with pytest.raises(ValueError, match="samples_per_launch 3"):
        dist.make_render_fn_dist(
            ts, RenderConfig(**_cfg(samples_per_launch=3)),
            dist.Mesh(n_tile=4, n_spp=2, world=8))
    with pytest.raises(ValueError, match="needs 8 ranks"):
        dist.make_render_fn_dist(ts, RenderConfig(**_cfg()),
                                 dist.make_mesh(n_tile=8, n_spp=1,
                                                device="cpu"))


def test_one_process_mesh_renders_as_make_render_fn(cornell):
    """make_render_fn_dist on the 1 x 1 mesh of a process without a group:
    bit-equal to make_render_fn, stats included."""
    from rendertoy3c_tpu_torch.integrate.path import make_render_fn

    _, ts, _, tcam = cornell
    cfg = RenderConfig(**_cfg(integrator="pool"))
    scene, fac = dist.prepare_tracer_factory(ts, cfg, "auto", device="cpu")
    mesh = dist.make_mesh(device="cpu")
    assert mesh.shape == {"tile": 1, "spp": 1}
    step, _ = dist.make_render_fn_dist(scene, cfg, mesh, tracer_factory=fac)
    film = dist.film_create_sharded(cfg, mesh)
    ref_step = make_render_fn(scene, cfg, tracer=fac(scene, None, cfg),
                              device="cpu")
    ref = film_create(cfg.height, cfg.width, device="cpu")
    for _ in range(2):
        film, stats = step(tcam.params(), film)
        ref, s_ref = ref_step(tcam.params(), ref)
        assert int(stats.radiance_rays) == int(s_ref.radiance_rays)
        assert stats.pool_iters == s_ref.pool_iters > 0
    assert torch.equal(film.accum.view(torch.int32),
                       ref.accum.view(torch.int32))


def test_cpu_mesh_does_not_need_a_gpu():
    mesh = dist.make_mesh(device="cpu")
    assert mesh.device.type == "cpu" and mesh.world == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="GPU"):
            dist.make_mesh(device="cuda")


def test_default_mesh_is_the_gpu(cornell):
    """make_mesh() and render_distributed(mesh=None) run on the card: with
    no GPU they raise, and nothing renders on the CPU."""
    _, ts, _, tcam = cornell
    if torch.cuda.is_available():
        assert dist.make_mesh().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="GPU"):
        dist.make_mesh()
    with pytest.raises(RuntimeError, match="GPU"):
        dist.render_distributed(ts, tcam.params(), RenderConfig(**_cfg()),
                                tracer_factory=lambda *a: None)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_spp_ranks_render_the_fused_pipeline_at_their_share(cornell, shape):
    """kind="fused" over an spp axis: each rank's pipeline is a copy at
    its share of samples_per_launch (K4's refill reads it), so the mesh
    draws as many rays as one device and its mean keeps to one device's;
    with the full count every rank would draw n_spp times its samples."""
    _, ts, _, tcam = cornell
    cfg = RenderConfig(**_cfg(samples_per_launch=4, integrator="pool"))
    scene, fac = dist.prepare_tracer_factory(ts, cfg, "auto", device="cpu")
    full = fac(scene, None, cfg)
    assert isinstance(full, dist.FusedPipeline)
    local = fac(scene, None, RenderConfig(**_cfg(samples_per_launch=2,
                                                  integrator="pool")))
    assert local is not full and local.cfg.samples_per_launch == 2
    assert local.tables is full.tables
    film, rad, shad = mesh_render(scene, cfg, *shape, local, tcam.params(),
                                  1)
    one, s_one = render_frame(scene, tcam.params(), cfg, tracer=full,
                              device="cpu")
    a, b = film.accum.numpy(), one.accum.numpy()
    assert np.all(np.isfinite(a))
    assert abs(a.mean() - b.mean()) < 0.05 * b.mean()
    assert abs(rad - int(s_one.radiance_rays)) < 0.05 * rad
