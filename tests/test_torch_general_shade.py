"""The general shading of the port (integrate/path.py `_shade_and_nee`,
integrate/bsdf.py, math/microfacet.py, scene/light.py `sample_light`)
against the reference's, teacher-forced: the same hits, rays, streams and
live lanes through both, and the same shadow tracer (each package's brute
tracer). Streams, light picks and the shadow flags exact; floats at the
reference's own tolerance for its shading, rtol = 1e-4, atol = 1e-5 (the
last bits differ: XLA's CPU rsqrt is not 1 / sqrt, and XLA contracts
a + b * c into fused multiply-adds), but for
GGX lobes of alpha near 0, which hold at rtol = 1e-2 on at most 1% of the
elements (`_close`)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inst_util import to_port_iscene
from rendertoy3c_tpu.integrate import bsdf as j_bsdf
from rendertoy3c_tpu.integrate.config import RenderConfig as JConfig
from rendertoy3c_tpu.integrate.path import _shade_and_nee as j_shade
from rendertoy3c_tpu.math import microfacet as j_mf
from rendertoy3c_tpu.scene.light import sample_light as j_sample_light
from rendertoy3c_tpu.trace.intersect import Hit as JHit
from rendertoy3c_tpu.trace.intersect import \
    make_bruteforce_tracer as j_brute_tracer
from rendertoy3c_tpu_torch.integrate import bsdf
from rendertoy3c_tpu_torch.integrate.config import RenderConfig
from rendertoy3c_tpu_torch.integrate.path import (_shade_and_nee,
                                                  general_tables)
from rendertoy3c_tpu_torch.math import microfacet as mf
from rendertoy3c_tpu_torch.math import rng
from rendertoy3c_tpu_torch.scene.light import light_tensors, sample_light
from rendertoy3c_tpu_torch.trace.instanced import make_instanced_tracer
from rendertoy3c_tpu_torch.trace.intersect import make_bruteforce_tracer
from torch_port_util import (cornell_pair, material_cornell_pair,
                             textured_quad_meshes, to_port_scene)

TOL = dict(rtol=1e-4, atol=1e-5)
# GGX lobes at alpha down to 0.0025 amplify the one-ulp difference of the
# normalised half vector: such elements hold at rtol 1e-2
LOOSE = dict(rtol=1e-2, atol=1e-5)
N = 384


def _close(got, want, name=""):
    """Within TOL on at least 99% of the elements, within LOOSE on all."""
    got, want = got.numpy(), np.asarray(want)
    ok = np.isclose(got, want, **TOL)
    assert ok.mean() >= 0.99, (name, ok.mean())
    np.testing.assert_allclose(got, want, **LOOSE, err_msg=name)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def test_microfacet_matches_reference():
    r = np.random.default_rng(0)
    c = r.uniform(-0.2, 1.0, 256).astype(np.float32)
    a = r.uniform(0.01, 1.0, 256).astype(np.float32)
    eta = r.uniform(1.0, 2.5, 256).astype(np.float32)
    f0 = r.uniform(0, 1, (256, 3)).astype(np.float32)
    u1, u2 = r.uniform(0, 1, (2, 256)).astype(np.float32)
    pairs = [
        (mf.schlick_weight(_t(c)), j_mf.schlick_weight(c)),
        (mf.schlick_fresnel(_t(f0), _t(c)[:, None]),
         j_mf.schlick_fresnel(f0, c[:, None])),
        (mf.fresnel_dielectric(_t(c), _t(eta)),
         j_mf.fresnel_dielectric(c, eta)),
        (mf.d_ggx(_t(c), _t(a)), j_mf.d_ggx(c, a)),
        (mf.smith_g1(_t(c), _t(a)), j_mf.smith_g1(c, a)),
        (mf.smith_g(_t(c), _t(c[::-1].copy()), _t(a)),
         j_mf.smith_g(c, c[::-1], a)),
        (mf.sample_ggx_half(_t(u1), _t(u2), _t(a)),
         j_mf.sample_ggx_half(u1, u2, a)),
        (mf.ggx_half_pdf(_t(c), _t(c[::-1].copy()), _t(a)),
         j_mf.ggx_half_pdf(c, c[::-1], a)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _mat_params(pkg, r, n):
    mt = np.arange(n) % 4
    fields = dict(
        mtype=mt.astype(np.int32),
        albedo=r.uniform(0, 1, (n, 3)).astype(np.float32),
        roughness=r.uniform(0.05, 1, n).astype(np.float32),
        metallic=r.uniform(0, 1, n).astype(np.float32),
        ior=r.uniform(1.1, 2.0, n).astype(np.float32),
        transmittance=r.uniform(0, 1, n).astype(np.float32),
        sheen=r.uniform(0, 0.5, n).astype(np.float32))
    if pkg == "jax":
        return j_bsdf.MatParams(**{k: jnp.asarray(v)
                                   for k, v in fields.items()})
    return bsdf.MatParams(**{k: _t(v) for k, v in fields.items()})


def _unit(r, n):
    v = r.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def test_bsdf_sample_and_eval_match_reference():
    """All four material types on seeded normals, directions and draws."""
    r = np.random.default_rng(1)
    n = 512
    jp, tp = _mat_params("jax", r, n), _mat_params("torch", np.random.
                                                   default_rng(1), n)
    ns, wo, wi = _unit(r, n), _unit(r, n), _unit(r, n)
    wo = np.where((wo * ns).sum(1, keepdims=True) < 0, -wo, wo)
    z1, u1, u2 = r.uniform(0, 1, (3, n)).astype(np.float32)
    js = j_bsdf.bsdf_sample(jp, ns, wo, z1, u1, u2)
    ts = bsdf.bsdf_sample(tp, _t(ns), _t(wo), _t(z1), _t(u1), _t(u2))
    for name in ("wi", "weight", "pdf"):
        _close(getattr(ts, name), getattr(js, name), name)
    np.testing.assert_array_equal(ts.is_delta.numpy(), np.asarray(js.is_delta))
    jf, jpdf = j_bsdf.bsdf_eval(jp, ns, wo, wi)
    tf, tpdf = bsdf.bsdf_eval(tp, _t(ns), _t(wo), _t(wi))
    _close(tf, jf, "f")
    _close(tpdf, jpdf, "pdf")


def test_sample_light_matches_reference():
    """Light::Sample with its guards: points far off, on the light's plane
    (omega < 1e-5) and on the light (dist^2 < 1e-5)."""
    js, ts, _, _ = cornell_pair()
    r = np.random.default_rng(2)
    n = 300
    idx = r.integers(0, ts.num_lights, n)
    u, v = r.uniform(0, 1, (2, n)).astype(np.float32)
    p = r.uniform(-1, 2, (n, 3)).astype(np.float32)
    p[:100, 1] = np.asarray(js.lights.v0)[idx[:100], 1]  # the light plane
    p[100:150] = np.asarray(js.lights.v0)[idx[100:150]]  # on the light
    want = j_sample_light(js.lights, jnp.asarray(idx), u, v, p)
    got = sample_light(light_tensors(ts.lights, "cpu"), _t(idx), _t(u),
                       _t(v), _t(p))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert (got[2].numpy()[100:150] == 1.0).all()  # the degenerate guard


def _emissive_rough_pair():
    """The textured quad's floor made PRINCIPLED, emissive (2, 2, 2) with
    its texture as the emissive and roughness maps."""
    from rendertoy3c_tpu.scene.scene import build_scene as j_build
    from rendertoy3c_tpu_torch.scene.material import MaterialType
    from rendertoy3c_tpu_torch.scene.scene import build_scene

    out = []
    for pkg, build in (("jax", j_build), ("torch", build_scene)):
        meshes, textures, cam = textured_quad_meshes(pkg)
        meshes[0].material = dataclasses.replace(
            meshes[0].material,
            material_type=MaterialType.PRINCIPLED, roughness=0.5,
            emissive=(2.0, 2.0, 2.0), emissive_texture_id=0,
            roughness_texture_id=0)
        out += [build(meshes, textures=textures), cam]
    js, jcam, ts, tcam = out
    return js, ts, jcam, tcam


def _instanced_pair():
    from rendertoy3c_tpu.scene.builtin import instanced_cornell
    from rendertoy3c_tpu.scene.instanced import build_instanced_scene

    meshes, instances, cam = instanced_cornell()
    js = build_instanced_scene(meshes, instances)
    return js, to_port_iscene(js), cam, cam


CASES = {
    "lambert": (cornell_pair, {}),
    "physical": (cornell_pair, dict(throughput_model="physical")),
    "four_types": (material_cornell_pair, {}),
    "four_types_power": (material_cornell_pair, dict(light_sampler="power")),
    "four_types_physical": (material_cornell_pair,
                            dict(throughput_model="physical")),
    "emissive_roughness_textures": (_emissive_rough_pair, {}),
    "normal_map": (None, {}),
    "instanced": (_instanced_pair, {}),
    "no_lights": (None, {}),
}


def _scenes(case):
    if case == "normal_map":
        from rendertoy3c_tpu.scene.scene import build_scene as j_build
        from rendertoy3c_tpu_torch.scene.scene import build_scene

        jm, jt, jcam = textured_quad_meshes("jax", "normal_map")
        tm, tt, tcam = textured_quad_meshes("torch", "normal_map")
        return j_build(jm, textures=jt), build_scene(tm, textures=tt), \
            jcam, tcam
    if case == "no_lights":
        js, _, jcam, tcam = cornell_pair()
        js = dataclasses.replace(js, num_lights=0)
        return js, to_port_scene(js), jcam, tcam
    return CASES[case][0]()


@pytest.mark.parametrize("case", sorted(CASES))
def test_shade_and_nee_matches_reference(case):
    js, ts, _, cam = _scenes(case)
    kw = dict(width=16, height=16, **CASES[case][1])
    cfg, jcfg = RenderConfig(**kw), JConfig(**kw)
    r = np.random.default_rng(3)
    p = cam.params()
    xy = r.uniform(-1, 1, (N, 2)).astype(np.float32)
    d = xy[:, :1] * p.u + xy[:, 1:] * p.v + p.w
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = np.broadcast_to(p.eye, d.shape).astype(np.float32)
    if case == "instanced":
        tracer = make_instanced_tracer(ts, "cpu")
        from rendertoy3c_tpu.trace.instanced import \
            make_instanced_tracer as j_inst_tracer

        j_any = j_inst_tracer(js)[1]
    else:
        tracer = make_bruteforce_tracer(ts)
        j_any = j_brute_tracer(js)[1]
    time = np.zeros(N, np.float32)
    hit = tracer[0](_t(o), _t(d), 0.01, 1e16, _t(time))
    assert int((hit.prim >= 0).sum()) > N // 2
    seed = r.integers(0, 2**32, N, dtype=np.uint64)
    active = r.uniform(0, 1, N) < 0.9
    jhit = JHit(t=jnp.asarray(hit.t.numpy()), prim=jnp.asarray(
        hit.prim.numpy()), u=jnp.asarray(hit.u.numpy()),
        v=jnp.asarray(hit.v.numpy()),
        inst=None if hit.inst is None else jnp.asarray(hit.inst.numpy()))
    want = j_shade(js, jcfg, j_any, jhit, jnp.asarray(o), jnp.asarray(d),
                   jnp.asarray(seed.astype(np.uint32)), jnp.asarray(active))
    got = _shade_and_nee(general_tables(ts, "cpu"), cfg, tracer[1], hit,
                         _t(o), _t(d), rng.as_u32(_t(seed.astype(np.int64))),
                         _t(active))
    np.testing.assert_array_equal(got[0].numpy(),
                                  np.asarray(want[0]).astype(np.int64))
    names = ("emitted", "radiance", "new_org", "new_dir", "atten_factor")
    for name, a, b in zip(names, got[1:6], want[1:6]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=name)
    # the shadow flags and delta lobes; the AOV outputs (albedo, ns)
    for k in (6, 7):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in (8, 9):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL)
    if case == "emissive_roughness_textures":
        # the emissive map modulates the floor's emission
        em = got[1].numpy()[(hit.prim.numpy() >= 0)]
        assert em.max() > 0 and len(np.unique(em.round(4))) > 2
