"""K6's plain version with instance rows against the reference's
make_external_shader with inst_base (pallas_shade.py :447-501, :1747-1759)
in interpret mode, teacher-forced.

The reference kernel takes the instance rows gathered outside
(`instanced_attr_t` over `inst_attr_pack`); the port's plain version
gathers them by each lane's hit instance (`gather_inst_rows`, the
identity where the lane hit none). Four iterations at 512 lanes on the
instanced field at grid 4 (row-major misc, C-major misc, and C-major with
2 keys, whose shadow rays carry their time), the normal-mapped quad under
a rotated, scaled instance (the tangent's forward transform) and the
field with AOV (the world normal in the AOV rows). Both get the same rays,
closest hits and instances (the port's brute instanced tracer) and misc;
dead lanes restart as fresh camera paths. The rule of
tests/k6_agree_util.py, as in tests/test_torch_walk_shade.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k6_agree_util import check_iteration
from inst_util import j_field, ref_bumpy_quad, to_port_iscene
from rendertoy3c_tpu.integrate.config import RenderConfig as JConfig
from rendertoy3c_tpu.scene.instanced import \
    build_instanced_scene as j_build_instanced
from rendertoy3c_tpu.trace.hier_instanced import \
    split_order_instanced as j_split
from rendertoy3c_tpu.trace.pallas_shade import (inst_attr_pack,
                                                instanced_attr_t,
                                                make_external_shader,
                                                pack_rows128)
from rendertoy3c_tpu_torch.integrate.config import RenderConfig
from rendertoy3c_tpu_torch.integrate.walkpool import \
    make_inst_walkpool_pipeline
from rendertoy3c_tpu_torch.scene.camera import Camera
from rendertoy3c_tpu_torch.trace import shade
from rendertoy3c_tpu_torch.trace.instanced import make_instanced_tracer

POOL = 512


def _scene(case):
    """(reference scene, port scene, port camera), split-ordered."""
    if case == "normal_map":
        m, i, t, cam = ref_bumpy_quad()
        js = j_build_instanced(m, i, textures=t)
        cam = Camera(eye=cam.eye, lookat=cam.lookat, fov_y=cam.fov_y)
    else:
        js, jcam = j_field(case == "2key", 4)
        cam = Camera(eye=(0.0, 6.0, 9.0), lookat=(0.0, 0.5, 0.0),
                     fov_y=50.0)
    js = j_split(js)
    return js, to_port_iscene(js), cam


def _fresh(cam, n, rng, mw):
    """Camera rays, fresh paths (random seeds), 90% of the lanes alive;
    misc C-major [mw, n], the AOV accs random."""
    p = cam.params()
    xy = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    d = xy[:, :1] * p.u + xy[:, 1:] * p.v + p.w
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    rays = np.zeros((n, 8), np.float32)
    rays[:, 0:3], rays[:, 3:6] = p.eye, d
    rays[:, 6], rays[:, 7] = 0.01, 1e16
    misc = np.zeros((mw, n), np.float32)
    misc[0] = rng.integers(0, 2**32, n, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    misc[1:7] = 1.0
    misc[9] = (rng.uniform(size=n) < 0.9).astype(np.float32)
    misc[13] = np.arange(n)
    misc[14] = 1.0
    misc[16:] = rng.uniform(0, 1, (mw - 16, n))
    return rays, misc


@pytest.mark.parametrize("case, transposed", [
    ("field", False), ("field", True), ("2key", True),
    ("normal_map", True), ("aov", True)])
def test_inst_external_shade_ref_matches_reference(case, transposed):
    js, ts, cam = _scene("field" if case == "aov" else case)
    motion = ts.num_keys == 2
    kw = dict(width=16, height=16, samples_per_launch=2, max_depth=4,
              ray_block=POOL, integrator="pool", pool_pixel_major=True,
              aov=case == "aov")
    pipe = make_inst_walkpool_pipeline(ts, RenderConfig(**kw), "cpu")
    tables, config = pipe.shade_tables, pipe.shade_config
    assert (tables.tex is not None) == (case == "normal_map")
    j_shade, attr_rows, presample = make_external_shader(
        js, JConfig(**kw), motion=motion, interpret=True,
        transposed=transposed)
    np.testing.assert_array_equal(tables.attr.numpy(),
                                  np.asarray(attr_rows))
    packed = pack_rows128(attr_rows)[0]
    ipack = inst_attr_pack(js)
    closest = make_instanced_tracer(ts, "cpu")[0]
    mw = pipe.misc_w
    rng = np.random.default_rng(29)
    rays, misc = _fresh(cam, POOL, rng, mw)
    insts = set()
    for _ in range(4):
        rt = torch.as_tensor(rays)
        time = torch.as_tensor(rng.uniform(0, 1, POOL).astype(np.float32))
        hit = closest(rt[:, 0:3], rt[:, 3:6], rt[:, 6], rt[:, 7],
                      time if motion else None)
        insts |= set(hit.inst.unique().tolist())
        hit4 = torch.stack([hit.t, hit.prim.float(), hit.u, hit.v], dim=1)
        hit8 = np.concatenate([hit4.numpy(), np.zeros((POOL, 4), np.float32)],
                              axis=1)
        attr_t = instanced_attr_t(
            packed, attr_rows.shape[1], ipack, jnp.asarray(hit.prim.numpy()),
            jnp.asarray(hit.inst.numpy()), presample=presample,
            bu=jnp.asarray(hit.u.numpy()), bv=jnp.asarray(hit.v.numpy()))
        m_in = misc if transposed else misc.T.copy()
        want = [np.array(x) for x in j_shade(
            jnp.asarray(rays), jnp.asarray(hit8), jnp.asarray(m_in), attr_t,
            POOL)]
        got = [x.numpy() for x in shade.external_shade_ref(
            rt, hit4, torch.as_tensor(m_in), tables, config,
            transposed=transposed, inst=hit.inst)]
        assert [g.shape for g in got] == [w.shape for w in want]
        check_iteration(rays, hit4.numpy(), m_in, got, want, tables,
                        config, transposed, inst=hit.inst.numpy())
        if not transposed:
            want[1] = want[1].T
        rays = want[0]
        misc = want[1][:mw].copy()
        misc[10:13] += want[1][mw:mw + 3]
        dead = misc[9] <= 0
        fresh = _fresh(cam, POOL, rng, mw)
        rays[dead], misc[:, dead] = fresh[0][dead], fresh[1][:, dead]
    assert -1 in insts and len(insts) > 2


def test_gather_inst_rows_identity_for_misses():
    rows = torch.arange(36, dtype=torch.float32).view(2, 18)
    got = shade.gather_inst_rows(rows, torch.tensor([1, -1, 0]))
    assert got.shape == (18, 3)
    assert torch.equal(got[:, 0], rows[1]) and torch.equal(got[:, 2], rows[0])
    assert torch.equal(got[:, 1], torch.tensor([1.0, 0, 0, 0, 1, 0, 0, 0, 1]
                                               * 2))
