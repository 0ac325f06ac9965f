"""The material dispatch and the power light pick against the reference,
piece by piece.

Tables: the material table's roughness, metallic, ior, transmittance and
sheen columns and `build_shade_tables(dispatch=True)` array-equal to the
reference's on the Cornell box with all four material types and on the
textured quad (every `params_base` layout: 16, 23, 27, 29, 33), light rows
0-16 equal and row 17 the power CDF; the principled 4294-face town
(BASELINE config 5's scene) array-equal to the reference's. The power pick
equal to the reference's `pick_light_power` over 1e5 uniforms, u -> 1 and
ties from zero-power lights included. The plain principled eval against
the reference's `_principled_eval_local` on random directions: f and pdf
within rtol 1e-3, atol 1e-6, and 99.8% of them within rtol 2e-5 (the
kernel computes G in another operation order, and near-mirror roughness
makes D's 1 - cos_h^2 (1 - a^2) cancel). Teacher-forced against the reference kernels in
interpret mode (integer columns exact, float columns within rtol = atol =
3e-5 on at least 98% of lanes, as the untextured tests): K4 dispatch,
static and 2-key, on the material Cornell box; textured K4 dispatch on
the principled, normal-mapped quad; K5 dispatch with the power pick; K6
dispatch with the power pick on the principled 4294-face town, untextured
and textured."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendertoy3c_tpu.integrate.bsdf import MatParams, _principled_eval_local
from rendertoy3c_tpu.integrate.bsdf import _principled_f0
from rendertoy3c_tpu.scene.light import build_light_table as j_light_table
from rendertoy3c_tpu.scene.light import pick_light_power as j_pick_power
from rendertoy3c_tpu.trace.pallas_shade import build_shade_tables as j_tables
from rendertoy3c_tpu_torch.integrate.config import RenderConfig
from rendertoy3c_tpu_torch.scene.light import (build_light_table,
                                               pick_light_power)
from rendertoy3c_tpu_torch.scene.material import MaterialType
from rendertoy3c_tpu_torch.scene.town import town_scene
from rendertoy3c_tpu_torch.trace import bsdf, shade
from test_torch_external import KW as EXT_KW
from test_torch_external import _teacher_force as external_teacher_force
from test_torch_megakernel import CFG as K4_CFG
from test_torch_megakernel import (FLOAT_COLS, INT_COLS, _launches,
                                   _lane_match, _run_port)
from test_torch_trace_shade import CFG as K5_CFG
from test_torch_trace_shade import _teacher_force as k5_teacher_force
from torch_port_util import (assert_light_rows_equal, j_town_scene,
                             material_cornell_pair, textured_quad_pair)

COLUMNS = ("roughness", "metallic", "ior", "transmittance", "sheen")


def _tables_equal(js, ts, textured, uv_xform, nmap, f_limit=None):
    got = shade.build_shade_tables(ts, textured, uv_xform, nmap, f_limit,
                                   dispatch=True)
    want = j_tables(js, textured=textured, dispatch=True, f_limit=f_limit,
                    uv_xform=uv_xform, normal_maps=nmap)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert_light_rows_equal(got[1], want[1], ts)
    return got


@pytest.mark.parametrize("variant", ["material_cornell", "repeat",
                                     "uv_transform", "normal_map", "features",
                                     "principled"])
def test_dispatch_tables_array_equal(variant):
    if variant == "material_cornell":
        js, ts, _, _ = material_cornell_pair()
    else:
        js, ts, _, _ = textured_quad_pair(variant)
    for k in COLUMNS + ("mtype",):
        np.testing.assert_array_equal(getattr(ts.materials, k),
                                      np.asarray(getattr(js.materials, k)),
                                      err_msg=k)
    textured = ts.textured
    uv_xform, nmap = ts.any_uv_transform, ts.any_normal_map
    attr_t, _ = _tables_equal(js, ts, textured, uv_xform, nmap, f_limit=128)
    base = shade.params_row(textured, uv_xform, nmap)
    assert base == {"material_cornell": 16, "repeat": 23, "uv_transform": 29,
                    "normal_map": 27, "features": 33,
                    "principled": 27}[variant]
    assert attr_t.shape[0] == -(-(base + 6) // 8) * 8
    if variant in ("material_cornell", "principled"):
        assert not ts.all_diffuse
        assert shade.shade_tables_for(ts, "cpu")[3] == base


@pytest.fixture(scope="module")
def principled_towns(tmp_path_factory):
    """{textured: (reference scene, port scene, port camera)} of the
    principled 4294-face town (BASELINE config 5's scene)."""
    out = {}
    for textured in (False, True):
        js, _ = j_town_scene(4000, False,
                             tmp_path_factory.mktemp(f"ptown{int(textured)}"),
                             textured=textured, principled=True)
        ts, cam = town_scene(4000, textured=textured, principled=True)
        out[textured] = (js, ts, cam)
    return out


def test_principled_town_tables_array_equal(principled_towns):
    js, ts, _ = principled_towns[True]
    assert ts.num_faces == 4294 and ts.num_lights == js.num_lights == 6
    emissive = np.asarray(ts.materials.emission).max(axis=1) > 0
    mtype = np.asarray(ts.materials.mtype)
    assert (mtype[~emissive] == int(MaterialType.PRINCIPLED)).all()
    assert (mtype[emissive] == int(MaterialType.DIFFUSE)).all()
    for k in ts.materials._fields:
        np.testing.assert_array_equal(getattr(ts.materials, k),
                                      np.asarray(getattr(js.materials, k)),
                                      err_msg=k)
    np.testing.assert_array_equal(ts.lights.power_cdf,
                                  np.asarray(js.lights.power_cdf))
    _tables_equal(js, ts, True, ts.any_uv_transform, ts.any_normal_map)
    # the lights are of unequal power, so the pick differs from uniform
    assert len(np.unique(np.round(np.diff(np.concatenate(
        [[0.0], ts.lights.power_cdf])), 6))) > 1


def test_power_pick_matches_reference():
    rng = np.random.default_rng(9)
    n_l = 7
    v0 = rng.uniform(-1, 1, (n_l, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(0.1, 1, (n_l, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(0.1, 1, (n_l, 3)).astype(np.float32)
    emission = rng.uniform(0.5, 20, (n_l, 3)).astype(np.float32)
    emission[[0, 3, 4]] = 0.0  # zero-power lights: ties in the CDF
    ours = build_light_table(v0, v1, v2, emission)
    theirs = j_light_table(v0, v1, v2, emission)
    cdf = ours.power_cdf
    np.testing.assert_array_equal(cdf, np.asarray(theirs.power_cdf))
    assert (np.diff(cdf) == 0).sum() >= 2 and cdf[0] == 0.0
    u = rng.uniform(0, 1, 100_000).astype(np.float32)
    u[:6] = [0.0, np.nextafter(np.float32(1), np.float32(0)), 1.0, cdf[1],
             cdf[2], cdf[-2]]
    idx, pdf = pick_light_power(torch.as_tensor(u), torch.as_tensor(cdf), n_l)
    j_idx, j_pdf = j_pick_power(theirs, n_l, jnp.asarray(u))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(pdf.numpy(), np.asarray(j_pdf))
    # the kernels' rule: the count of CDF entries <= u, clamped
    count = np.minimum((u[:, None] >= cdf[None]).sum(axis=1), n_l - 1)
    np.testing.assert_array_equal(idx.numpy(), count)
    assert not np.isin(idx.numpy(), [0, 3, 4]).any()  # zero power, never
    # the light table's row 16 is the same pdf, computed once per light
    lights = shade.build_shade_tables(_light_scene(ours))[1]
    np.testing.assert_array_equal(lights[16, idx.numpy().astype(int)],
                                  pdf.numpy())


def _light_scene(lights):
    """A stand-in scene carrying only a light table, for its shade
    tables' light rows."""
    from rendertoy3c_tpu_torch.scene.builtin import cornell_box
    from rendertoy3c_tpu_torch.scene.scene import build_scene

    scene = build_scene(cornell_box()[0])
    return dataclasses.replace(scene, lights=lights,
                               num_lights=len(lights.area))


def test_principled_eval_matches_reference():
    rng = np.random.default_rng(4)
    n = 20000

    def dirs(z_lo):
        w = rng.normal(size=(n, 3))
        w[:, 2] = np.abs(w[:, 2]) * np.sign(rng.uniform(z_lo, 1, n))
        return (w / np.linalg.norm(w, axis=1, keepdims=True)).astype(
            np.float32)

    wo, wi = dirs(0.0), dirs(-0.3)  # some wi below the surface
    albedo = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    rough, metal, sheen = (rng.uniform(lo, hi, n).astype(np.float32)
                           for lo, hi in ((0.05, 1), (0, 1), (0, 0.5)))
    ior = rng.uniform(1.1, 2.4, n).astype(np.float32)
    rows = [np.full(n, 3.0, np.float32), rough, metal, ior,
            np.zeros(n, np.float32), sheen]
    m = bsdf.material_lanes([torch.as_tensor(r) for r in rows], 0,
                            [torch.as_tensor(albedo[:, c]) for c in range(3)])
    f, pdf = bsdf.principled_eval(
        m, tuple(torch.as_tensor(wo[:, c]) for c in range(3)),
        tuple(torch.as_tensor(wi[:, c]) for c in range(3)))
    p = MatParams(mtype=jnp.full(n, 3), albedo=jnp.asarray(albedo),
                  roughness=jnp.asarray(rough), metallic=jnp.asarray(metal),
                  ior=jnp.asarray(ior), transmittance=jnp.zeros(n),
                  sheen=jnp.asarray(sheen))
    j_f, j_pdf = _principled_eval_local(p, _principled_f0(p),
                                        jnp.asarray(wo), jnp.asarray(wi))
    for got, want in ((torch.stack(f, 1).numpy(), np.asarray(j_f)),
                      (pdf.numpy(), np.asarray(j_pdf))):
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6)
        assert np.isclose(got, want, rtol=2e-5, atol=1e-6).mean() > 0.998
    assert (pdf.numpy() == 0).any() and (pdf.numpy() > 0).mean() > 0.5


@pytest.mark.parametrize("motion", [False, True])
def test_dispatch_refill_ref_matches_reference_kernel(motion):
    """K4 dispatch (and its motion variant) on the material Cornell box:
    8 launches, stats (and the time buffer) exact."""
    _refill_teacher_force(motion, material_cornell_pair(motion))


def test_textured_dispatch_refill_ref_matches_reference_kernel():
    """Textured K4 dispatch on the principled, normal-mapped quad."""
    _refill_teacher_force(False, textured_quad_pair("principled"))


def _refill_teacher_force(motion, scenes):
    ts, tcam, steps = _launches(motion, scenes)
    pipe = shade.FusedPipeline(ts, RenderConfig(**K4_CFG), "cpu")
    assert pipe.tables.params_base > 0
    seen, after_delta = set(), False
    for inputs, want in steps:
        got = _run_port(ts, tcam, inputs, "cpu", shade.trace_shade_refill)
        np.testing.assert_array_equal(got[3], want[4])  # stats
        if motion:
            np.testing.assert_array_equal(got[4].view(np.uint32),
                                          want[3].view(np.uint32))
        assert _lane_match(got[1], want[1], INT_COLS, exact=True) >= 0.98
        assert _lane_match(got[1], want[1], FLOAT_COLS, exact=False) >= 0.98
        assert _lane_match(got[0], want[0], list(range(8)), False) >= 0.98
        assert _lane_match(got[2], want[2], list(range(16)), False) >= 0.98
        seen |= live_material_types(pipe, *inputs[:2], inputs[5])
        after_delta |= bool((want[1][:, 7] > 0).any())
    # the lanes shaded every material type of the scene, and paths went on
    # after a delta lobe where the scene has one
    types = set(np.asarray(ts.materials.mtype).tolist())
    assert seen >= types, (seen, types)
    assert after_delta == bool(types & {1, 2})


def live_material_types(pipe, rays, misc, time=None):
    """The material types of the faces that a state's live lanes hit,
    through the plain closest sweep of a FusedPipeline."""
    rays = torch.as_tensor(rays)
    count = torch.tensor([rays.shape[0]], dtype=torch.int32)
    tm = None if time is None or not pipe.motion else torch.as_tensor(time)
    prim = shade._plain_sweeps(pipe.tables, count, tm)[0](rays)[:, 1]
    prim = prim.numpy().astype(np.int64)
    on = (np.asarray(misc)[:, 9] > 0) & (prim >= 0)
    mat = np.asarray(pipe.scene.geom.mat_id)[prim[on]]
    return set(np.asarray(pipe.scene.materials.mtype)[mat].tolist())


def test_dispatch_power_trace_shade_ref_matches_reference_kernel():
    """K5 dispatch with the power pick on the material Cornell box."""
    k5_teacher_force(False, material_cornell_pair(),
                     dict(K5_CFG, light_sampler="power"))


@pytest.mark.parametrize("textured", [False, True])
def test_dispatch_power_external_shade_ref_matches_reference_kernel(
        principled_towns, textured):
    """K6 dispatch with the power pick on the principled town."""
    external_teacher_force(principled_towns[textured], False,
                           dict(EXT_KW, light_sampler="power"))
