"""`prepare_tracer_factory` (parallel/dist.py) against the reference's
(rendertoy3c_tpu/parallel/dist.py:75-225): the tracer of every kind for
the Cornell box, the instanced Cornell box and a 19202-face grid under
the pool and the wave integrator, and the returned scene's face order,
equal to the reference's; the kinds the port has not ported raise naming
their item."""
import dataclasses

import numpy as np
import pytest
import torch

from inst_util import to_port_iscene
from rendertoy3c_tpu.integrate.config import RenderConfig as JConfig
from rendertoy3c_tpu.parallel import dist as jdist
from rendertoy3c_tpu_torch.integrate.config import RenderConfig
from rendertoy3c_tpu_torch.parallel import dist
from rendertoy3c_tpu_torch.trace.intersect import make_bruteforce_tracer
from torch_port_util import cornell_pair


def _cfg(**kw):
    base = dict(width=32, height=32, samples_per_launch=2, max_depth=3,
                ray_block=256)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def cornell():
    return cornell_pair()[:2]


@pytest.fixture(scope="module")
def inst_cornell():
    from rendertoy3c_tpu.scene.builtin import instanced_cornell
    from rendertoy3c_tpu.scene.instanced import build_instanced_scene

    meshes, instances, _ = instanced_cornell()
    js = build_instanced_scene(meshes, instances)
    return js, to_port_iscene(js)


def _kind_of(tracer) -> str:
    if isinstance(tracer, tuple):
        return "pair"
    return type(tracer).__name__


def _faces(scene):
    return np.asarray(scene.geom.v0[0])


ROUTES = [("cornell", k, i) for k in ("auto", "fused", "walkpool",
                                      "external", "hierwalk", "pallas",
                                      "brute")
          for i in ("pool", "wave")] + [
    ("inst", k, i) for k in ("auto", "walkpool", "external", "pallas")
    for i in ("pool", "wave")] + [("grid", "auto", "pool")]


@pytest.mark.parametrize("scene_name, kind, integrator", ROUTES)
def test_routing_matches_reference(cornell, inst_cornell, scene_name, kind,
                                   integrator):
    """The tracer type of every kind and the returned scene's face order
    equal the reference's; kinds the port has not ported raise naming
    their item, and a pipeline under the wave integrator, which the
    reference's render refuses, is refused when it is built."""
    if scene_name == "grid":
        from torch_port_util import lit_grid_scene

        js, ts = lit_grid_scene("jax"), lit_grid_scene("torch")
    else:
        js, ts = (cornell if scene_name == "cornell" else inst_cornell)[:2]
    kw = _cfg(integrator=integrator, ray_block=512)
    js2, jfac = jdist.prepare_tracer_factory(js, JConfig(**kw), kind,
                                             interpret=True)
    want = jfac(js2, None, JConfig(**kw))
    try:
        ts2, fac = dist.prepare_tracer_factory(ts, RenderConfig(**kw), kind,
                                               device="cpu")
    except NotImplementedError as e:
        if integrator == "wave" and _kind_of(want) != "pair":
            # the port's pipelines refuse the wave integrator when built,
            # the reference's when they render (integrate/path.py)
            assert "wave integrator" in str(e)
        else:
            assert _kind_of(want) == "pair" and "A17" in str(e)
        return
    got = fac(ts2, None, RenderConfig(**kw))
    assert _kind_of(got) == _kind_of(want)
    np.testing.assert_array_equal(_faces(ts2), _faces(js2))


def test_leafwalk_and_three_key_hierwalk_raise(cornell):
    """kind="leafwalk" raises naming A17; kind="hierwalk" on a 3-key
    scene, which raised naming A5, now builds the stacked walk."""
    _, ts = cornell
    cfg = RenderConfig(**_cfg())
    with pytest.raises(NotImplementedError, match="A17"):
        dist.prepare_tracer_factory(ts, cfg, "leafwalk", device="cpu")
    g = ts.geom
    three = dataclasses.replace(
        ts, num_keys=3, geom=g._replace(**{
            k: np.concatenate([getattr(g, k)] * 3)
            for k in ("v0", "e1", "e2", "n0", "n1", "n2")}))
    # 3 keys (A5, ported): the "hierwalk" factory walks the stacked
    # segment tables, and traces as the brute tracer
    ordered, fac = dist.prepare_tracer_factory(three, cfg, "hierwalk",
                                               device="cpu")
    closest, any_hit = fac(ordered, None, cfg)
    rng = np.random.default_rng(9)
    o = torch.tensor(rng.uniform(-0.9, 0.9, (256, 3)), dtype=torch.float32)
    o[:, 1] = 1.0
    d = torch.tensor(rng.normal(size=(256, 3)), dtype=torch.float32)
    d = d / d.norm(dim=1, keepdim=True)
    tm = torch.tensor(rng.random(256), dtype=torch.float32)
    want = make_bruteforce_tracer(ordered)
    hit = closest(o, d, 1e-3, 1e16, tm)
    assert torch.equal(hit.prim, want[0](o, d, 1e-3, 1e16, tm).prim)
    assert (hit.prim >= 0).float().mean() > 0.5
    assert torch.equal(any_hit(o, d, 1e-3, 0.5, tm),
                       want[1](o, d, 1e-3, 0.5, tm))
