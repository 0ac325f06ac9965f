"""K7's plain version, the static two-level sweep
(trace/instanced_mt.py), against the reference's Pallas kernel
(rendertoy3c_tpu/trace/pallas_instanced.py) in interpret mode.

The object-space soup, the instance table and the tile ranges are
array-equal to the reference's. On the reference test's 3-instance scene
(tests/test_pallas_instanced.py) and on bench's trace-time Cornell
(`multi_instance_cornell`, 15 instances), 1000 seeded rays (a partial last
ray tile) at the full count and at a count of 700 (the last tile
skipped): prims, instances and occlusion exact, t within T_TOL and u, v
within UV_TOL. t agreed bit for bit on these rays; u and v differ by up
to 1.9e-7: XLA's CPU backend contracts a + b * c into fused multiply-adds
(tests/test_torch_general_pool.py `test_reference_hit_point_is_fused`),
the MT test's u among them. A 20^2 general-pool render over the port's
K7 pair against the reference's `render_frame` over its Pallas pair, at
the reference test's rtol = atol = 1e-4, the ray counts within
MAX_RAY_DIFF (the general pool's bound, same cause). A 2-key scene
raises the reference's ValueError."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inst_util import j_multi_instance_cornell, to_port_iscene
from rendertoy3c_tpu.trace import pallas_instanced as jpi
from rendertoy3c_tpu_torch.trace import instanced_mt as im
from rendertoy3c_tpu_torch.trace.instanced import make_instanced_tracer
from rendertoy3c_tpu_torch.trace.mt import pack_rays

N = 1000
T_TOL = 1e-6
UV_TOL = 1e-6
MAX_RAY_DIFF = 12  # tests/test_torch_general_pool.py


def _xform(translate=(0, 0, 0), scale=1.0):
    t = np.zeros((3, 4), np.float32)
    t[:, :3] = np.eye(3) * scale
    t[:, 3] = translate
    return t


def j_three_instances():
    """The reference's scene of tests/test_pallas_instanced.py:24-37,
    copied: a box placed twice and a lamp."""
    from rendertoy3c_tpu.scene.builtin import box_mesh, quad
    from rendertoy3c_tpu.scene.instanced import build_instanced_scene
    from rendertoy3c_tpu.scene.material import Material
    from rendertoy3c_tpu.scene.mesh import Mesh
    from rendertoy3c_tpu.scene.scene import Instance

    white = Material(diffuse=(0.7, 0.7, 0.7))
    light = Material(emissive=(12.0, 12.0, 12.0))
    box = box_mesh([-0.3, 0.0, -0.3], [0.3, 0.6, 0.3], white)
    lv, lf = quad([-0.4, 2.0, -0.4], [-0.4, 2.0, 0.4], [0.4, 2.0, 0.4],
                  [0.4, 2.0, -0.4])
    lamp = Mesh(vertices=lv[None], indices=lf, material=light)
    instances = [
        Instance(mesh_index=0, transforms=_xform((-0.7, 0, 0))),
        Instance(mesh_index=0, transforms=_xform((0.7, 0, 0), scale=0.5)),
        Instance(mesh_index=1),
    ]
    return build_instanced_scene([box, lamp], instances)


SCENES = {"three_instances": j_three_instances,
          "multi_instance_cornell": lambda: j_multi_instance_cornell()[0]}
RAY_BOX = {"three_instances": ([-1.5, 0.1, -1.5], [1.5, 1.8, 1.5]),
           "multi_instance_cornell": ([-0.9, 0.05, -0.9], [0.9, 1.9, 0.9])}


@pytest.fixture(scope="module", params=sorted(SCENES))
def pair(request):
    js = SCENES[request.param]()
    return request.param, js, to_port_iscene(js)


def _rays(name, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(*RAY_BOX[name], (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmax = rng.uniform(0.1, 3.0, N).astype(np.float32)
    return o, d, tmax


def test_soup_table_and_ranges_array_equal(pair):
    _, js, ts = pair
    tris, table, ranges = jpi.build_instanced_soup(js)
    soup = im.build_instanced_soup(ts, "cpu")
    np.testing.assert_array_equal(soup.tris.numpy(), np.asarray(tris))
    np.testing.assert_array_equal(soup.table.numpy(), np.asarray(table))
    assert soup.tile_ranges == ranges
    assert soup.inst_tiles.tolist() == [list(ranges[m])
                                        for m in js.instance_mesh]


@pytest.mark.parametrize("count", [N, 700])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_plain_k7_matches_reference_kernel(pair, any_hit, count):
    name, js, ts = pair
    o, d, tmax = _rays(name, 3 + int(any_hit))
    if not any_hit:
        tmax = np.full(N, 1e16, np.float32)
    tris, table, ranges = jpi.build_instanced_soup(js)
    want = np.asarray(jpi._trace_instanced(
        tris, table, jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(tmax),
        instance_mesh=js.instance_mesh, tile_ranges=ranges, any_hit=any_hit,
        count=count, interpret=True))
    rays, r = pack_rays(torch.from_numpy(o), torch.from_numpy(d), 1e-3,
                        torch.from_numpy(tmax))
    got = im.trace_instanced_ref(
        rays, torch.tensor([count], dtype=torch.int32),
        im.build_instanced_soup(ts, "cpu"), any_hit)[:r].numpy()
    if any_hit:
        np.testing.assert_array_equal(got, want)
        assert 0 < got[:, 0].sum() < N
        return
    np.testing.assert_array_equal(got[:, 1], want[:, 1])  # prim
    np.testing.assert_array_equal(got[:, 4], want[:, 4])  # instance
    np.testing.assert_array_equal(got[:, 5:], want[:, 5:])
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=T_TOL, atol=T_TOL)
    np.testing.assert_allclose(got[:, 2:4], want[:, 2:4], rtol=UV_TOL,
                               atol=UV_TOL)
    # hit shares: 4.6-6.1% on the open 3-instance scene
    assert (got[:, 1] >= 0).mean() > 0.03
    if count < N:  # the skipped tile keeps its initial row
        tail = got[768:]
        assert (tail[:, 1] == -1).all() and (tail[:, 4] == -1).all()


def test_tracer_matches_reference_and_brute(pair):
    """make_instanced_mt_tracer's Hit against the reference's
    make_pallas_instanced_tracer and the port's brute instanced tracer."""
    name, js, ts = pair
    o, d, tmax = _rays(name, 11)
    closest, any_hit = im.make_instanced_mt_tracer(ts, "cpu")
    j_closest, j_any = jpi.make_pallas_instanced_tracer(js, interpret=True)
    b_closest, b_any = make_instanced_tracer(ts, "cpu")
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    h = closest(ot, dt, 1e-2, 1e16, None)
    jh = j_closest(jnp.asarray(o), jnp.asarray(d), 1e-2, 1e16, None)
    bh = b_closest(ot, dt, 1e-2, 1e16)
    for want in (jh, bh):
        np.testing.assert_array_equal(h.prim.numpy(), np.asarray(want.prim))
        np.testing.assert_array_equal(h.inst.numpy(), np.asarray(want.inst))
        np.testing.assert_allclose(h.t.numpy(), np.asarray(want.t),
                                   rtol=1e-5, atol=1e-5)
    occ = any_hit(ot, dt, 1e-3, torch.from_numpy(tmax), None)
    np.testing.assert_array_equal(
        occ.numpy(), np.asarray(j_any(jnp.asarray(o), jnp.asarray(d), 1e-3,
                                      jnp.asarray(tmax), None)))
    np.testing.assert_array_equal(
        occ.numpy(), b_any(ot, dt, 1e-3, torch.from_numpy(tmax)).numpy())
    plain = im.make_instanced_mt_tracer(ts, "cpu", plain=True)[0]
    assert torch.equal(plain(ot, dt, 1e-2, 1e16, None).prim, h.prim)


def test_general_pool_render_matches_reference():
    """20^2, 1 spp, depth 3 under the general pool (the reference test's
    config, tests/test_pallas_instanced.py:71-82, on the pool)."""
    from rendertoy3c_tpu.integrate.config import RenderConfig as JConfig
    from rendertoy3c_tpu.integrate.path import render_frame as j_render
    from rendertoy3c_tpu.scene.camera import Camera as JCamera
    from rendertoy3c_tpu_torch.integrate.config import RenderConfig
    from rendertoy3c_tpu_torch.integrate.path import render_frame
    from rendertoy3c_tpu_torch.scene.camera import Camera

    js = j_three_instances()
    ts = to_port_iscene(js)
    kw = dict(width=20, height=20, samples_per_launch=1, max_depth=3,
              ray_block=512, integrator="pool")
    view = dict(eye=(0, 1.5, 4.0), lookat=(0, 0.5, 0), fov_y=45.0)
    f_ref, s_ref = j_render(
        js, JCamera(**view).params(), JConfig(**kw), subframes=1,
        tracer=jpi.make_pallas_instanced_tracer(js, interpret=True))
    f, s = render_frame(ts, Camera(**view).params(), RenderConfig(**kw),
                        subframes=1,
                        tracer=im.make_instanced_mt_tracer(ts, "cpu"),
                        device="cpu")
    np.testing.assert_allclose(f.accum.numpy(), np.asarray(f_ref.accum),
                               rtol=1e-4, atol=1e-4)
    assert float(f.accum.mean()) > 0.0
    for got, want in ((s.radiance_rays, s_ref.radiance_rays),
                      (s.shadow_rays, s_ref.shadow_rays)):
        assert abs(int(got) - int(want)) <= MAX_RAY_DIFF


def test_two_keys_raise_the_reference_error():
    from rendertoy3c_tpu_torch.scene.builtin import instance_field
    from rendertoy3c_tpu_torch.scene.instanced import build_instanced_scene

    meshes, inst, _ = instance_field(True, 2)
    scene = build_instanced_scene(meshes, inst)
    assert scene.num_keys == 2
    with pytest.raises(ValueError, match="supports static scenes"):
        im.make_instanced_mt_tracer(scene, "cpu")
    with pytest.raises(ValueError, match="supports static scenes"):
        jpi.make_pallas_instanced_tracer(
            dataclasses.replace(j_three_instances(), num_keys=2))
