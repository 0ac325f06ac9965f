"""The megakernels' in-block sweeps (K4, K5: kernels/csrc/mt.cuh) on the
CPU: they stage and test only a soup's real faces, and split each lane's
faces between the G threads of its group, merging the group's hits after
every tile.

- The soup's columns past its real faces are zero (what makes the cut
  exact) for the builtin scenes, BASELINE config 3's baked
  `multi_instance_tlas`, a 2-key scene, a 1502-face `.obj` and the
  tests' own scenes (tests/megakernel_util.py); the fused tables refuse a
  soup whose padding is not.
- The plain sweeps restricted to the real faces (`real_face_sweep`) give
  `closest_ref` / `any_ref` bit for bit, and both match the reference's
  Pallas kernels in interpret mode (prims and occlusion exact, t/u/v
  within 1e-6 on Cornell, and within tests/test_torch_mt_bin.py's 5e-4 +
  1e-4 of their size on the random soup: the reference's CPU backend
  contracts a*b + c into FMAs), at live counts 0, 301 (inside a 256-ray
  block) and all.
- `group_sweep`, a twin of the kernels' schedule (the 256-ray block vote
  on unpadded boxes at each ray's best t so far, thread g of a group
  testing the real columns j = g mod G in order under its own best t, the
  group's least (t, prim) after each tile, an any-hit group's OR), gives
  the plain sweeps' outputs bit for bit at G = 1, 2 and 4 on the ties
  scene (a face and its copy in different threads of a group), a
  two-tile soup of 800 faces and the 2-key Cornell box.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one intra-op thread per worker)
from megakernel_util import FORMS, KINDS, fused_scene, tie_columns
from mt_bin_util import rays_at, scattered_soup
from rendertoy3c_tpu.trace.pallas_mt import build_tri_soup as j_soup
from rendertoy3c_tpu.trace.pallas_mt import trace_any_mt as j_any
from rendertoy3c_tpu.trace.pallas_mt import trace_closest_mt as j_closest
from rendertoy3c_tpu_torch.integrate.config import RenderConfig
from rendertoy3c_tpu_torch.io.obj import load_obj
from rendertoy3c_tpu_torch.scene.builtin import (multi_instance_cornell,
                                                  textured_quad_variant)
from rendertoy3c_tpu_torch.scene.scene import build_scene
from rendertoy3c_tpu_torch.trace import mt, shade
from torch_port_util import cornell_pair, moving_cornell_pair, random_rays

BLOCK = mt.RAY_TILE  # the megakernels' vote spans 256 lanes
COUNTS = (0, 301, None)
TOL = dict(rtol=1e-6, atol=1e-6)
# the random soup's slivers amplify the reference's FMAs (as in
# tests/test_torch_mt_bin.py)
SOUP_TOL = dict(rtol=1e-4, atol=5e-4)


def _padding_is_zero(tris, n_faces):
    cols = tris.permute(1, 0, 2).reshape(9, -1)
    return bool((cols[:, n_faces:] == 0).all())


def _write_obj(path, n=30, m=25):
    """An .obj of an n x m height-field grid (2 n m faces) and a lamp quad
    of its own material (2 faces), with its .mtl."""
    rng = np.random.default_rng(9)
    with open(path.with_suffix(".mtl"), "w") as f:
        f.write("newmtl ground\nKd 0.7 0.7 0.7\n\n"
                "newmtl lamp\nKd 0 0 0\nKe 12 12 12\n")
    lines = [f"mtllib {path.with_suffix('.mtl').name}"]
    for i in range(n + 1):
        for k in range(m + 1):
            lines.append(f"v {i * 0.1 - 1.5:.4f} {rng.uniform(0, 0.2):.4f} "
                         f"{k * 0.1 - 1.25:.4f}")
    lines.append("usemtl ground")
    for i in range(n):
        for k in range(m):
            a = i * (m + 1) + k + 1
            b, c = a + m + 1, a + 1
            lines += [f"f {a} {b} {b + 1}", f"f {a} {b + 1} {c}"]
    base = (n + 1) * (m + 1)
    lines += ["v -0.3 2 -0.3", "v 0.3 2 -0.3", "v 0.3 2 0.3", "v -0.3 2 0.3",
              "usemtl lamp", f"f {base + 1} {base + 2} {base + 3}",
              f"f {base + 1} {base + 3} {base + 4}"]
    path.write_text("\n".join(lines) + "\n")


def _scene(name, tmp_path):
    """A scene of the padding check by name (SCENE_NAMES)."""
    if name == "cornell":
        return cornell_pair()[1]
    if name == "moving_cornell":
        return moving_cornell_pair()[1]
    if name.startswith("quad_"):
        meshes, textures, _ = textured_quad_variant(name[5:])
        return build_scene(meshes, textures=textures)
    if name == "config3_baked":
        meshes, inst, _ = multi_instance_cornell()
        return build_scene(meshes, instances=inst)
    if name == "obj_1502":
        path = tmp_path / "grid.obj"
        _write_obj(path)
        meshes, textures = load_obj(str(path))
        return build_scene(meshes, textures=textures)
    kind, form = name.split("_")
    return fused_scene(kind, form)[0]


SCENE_NAMES = (["cornell", "moving_cornell", "quad_repeat", "quad_normal_map",
                "quad_principled", "config3_baked", "obj_1502"]
               + [f"{kind}_{form}" for kind in KINDS for form in FORMS[:4]])


@pytest.mark.parametrize("name", SCENE_NAMES)
def test_soup_padding_is_zero(name, tmp_path):
    """Every key's columns past num_faces are zero, and the fused tables
    (which pass num_faces to the kernels) accept the soup."""
    scene = _scene(name, tmp_path)
    if name == "obj_1502":
        assert scene.num_faces == 1502
    for key in range(scene.num_keys):
        soup = mt.build_tri_soup(scene.geom, "cpu", key=key,
                                 num_faces=scene.num_faces)
        assert soup.num_faces == scene.num_faces
        assert _padding_is_zero(soup.tris, scene.num_faces)
    cfg = RenderConfig(width=16, height=16, ray_block=256, integrator="pool")
    pipe = shade.FusedPipeline(scene, cfg, "cpu")
    assert pipe.tables.soup.num_faces == scene.num_faces


def test_fused_tables_refuse_a_soup_whose_padding_is_not_zero():
    _, ts, _, _ = cornell_pair()
    soup = mt.build_tri_soup(ts.geom, "cpu", num_faces=ts.num_faces)
    mt.require_zero_padding(soup.tris, ts.num_faces)
    tris = soup.tris.clone()
    tris[0, 4, ts.num_faces] = 1.0
    with pytest.raises(ValueError, match="not all zero"):
        mt.require_zero_padding(tris, ts.num_faces)


# ---------------------------------------------------------------- sweeps
def _count(count, r):
    return torch.tensor([r if count is None else count], dtype=torch.int32)


def real_face_sweep(rays, count, soup, any_hit: bool):
    """The plain sweep (mt._culled_sweep, per-ray culls) with each tile's
    test restricted to its real faces: the columns below num_faces."""
    ct = soup.tris.shape[2]

    def test(cols, k, idx):
        nf = min(ct, soup.num_faces - k * ct)
        return mt.mt_test(cols, soup.tris[k][:, :nf], k * ct)

    out = mt._culled_sweep(rays, count, BLOCK, soup.tris.shape[0], soup.aabb,
                           soup.super_aabb, test, any_hit)
    live = mt.live_rows(rays.shape[0], count)
    if any_hit:
        return mt._any_out(out, live)
    return mt._closest_out(rays, out, live)


def _box_hit(box, rays, inv, tcur):
    """mt.cuh box_hit of every ray against one box: [R] bool."""
    o = rays[:, 0:3]
    t0 = (box[0:3][None] - o) * inv
    t1 = (box[3:6][None] - o) * inv
    tn = torch.fmax(torch.fmax(torch.fmin(t0[:, 0], t1[:, 0]),
                               torch.fmin(t0[:, 1], t1[:, 1])),
                    torch.fmin(t0[:, 2], t1[:, 2]))
    tf = torch.fmin(torch.fmin(torch.fmax(t0[:, 0], t1[:, 0]),
                               torch.fmax(t0[:, 1], t1[:, 1])),
                    torch.fmax(t0[:, 2], t1[:, 2]))
    return (box[0] <= box[3]) & (tn <= tf) & (tf >= rays[:, 6]) & (tn <= tcur)


def group_sweep(rays, count, table, g_size: int, any_hit: bool, time=None):
    """Twin of mt.cuh's sweep_closest_with / sweep_any_with in blocks of
    256 rays of g_size threads each: [R, 4] as closest_ref / any_ref."""
    motion = time is not None
    tiles = table.tris0 if motion else table.tris
    n_tiles, _, ct = tiles.shape
    r = rays.shape[0]
    live = mt.live_rows(r, count)
    d = rays[:, 3:6]
    inv = torch.where(d.abs() > 1e-20, 1.0 / d, torch.full_like(d, 1e30))
    best = [rays[:, 7].clone(), torch.full((r,), -1.0), torch.zeros(r),
            torch.zeros(r)]
    occ = torch.zeros(r, dtype=torch.bool)
    unbounded = tuple(rays[:, c:c + 1] for c in range(7)) + (
        torch.full((r, 1), float("inf")),)

    def vote(box):
        tcur = rays[:, 7] if any_hit else best[0]
        hit = _box_hit(box, rays, inv, tcur)
        return hit.reshape(-1, BLOCK).any(dim=1).repeat_interleave(BLOCK)

    def visit(k, m):
        nf = min(ct, table.num_faces - k * ct)
        extra = (table.tris1[k][:, :nf], time[:, None]) if motion else ()
        t, u, v, hit, _ = mt.mt_test(unbounded, tiles[k][:, :nf], k * ct,
                                     *extra)
        if any_hit:  # each thread's first hit, OR-ed over the group
            for g in range(g_size):
                for j in range(g, nf, g_size):
                    occ[:] = occ | (m & hit[:, j] & (t[:, j] < rays[:, 7]))
            return
        members = []
        for g in range(g_size):
            bt, bp, bu, bv = (x.clone() for x in best)
            for j in range(g, nf, g_size):
                upd = m & hit[:, j] & (t[:, j] < bt)
                bt = torch.where(upd, t[:, j], bt)
                bp = torch.where(upd, torch.tensor(float(k * ct + j)), bp)
                bu = torch.where(upd, u[:, j], bu)
                bv = torch.where(upd, v[:, j], bv)
            members.append([bt, bp, bu, bv])
        merged = members[0]
        for other in members[1:]:  # the least (t, prim) of the group
            take = (other[0] < merged[0]) | ((other[0] == merged[0])
                                             & (other[1] < merged[1]))
            merged = [torch.where(take, a, b) for a, b in zip(other, merged)]
        best[:] = merged

    if n_tiles == 1:
        visit(0, live)
    elif n_tiles <= 2 * mt.SUPER_TILE:
        for k in range(n_tiles):
            visit(k, live & vote(table.aabb[k]))
    else:
        for ks in range(-(-n_tiles // mt.SUPER_TILE)):
            ms = live & vote(table.super_aabb[ks])
            for j in range(mt.SUPER_TILE):
                k = ks * mt.SUPER_TILE + j
                m = ms & vote(table.aabb[k])
                if k < n_tiles and bool(m.any()):
                    visit(k, m)
    if any_hit:
        return mt._any_out(occ, live)
    return torch.stack(best, dim=1)


def _bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _cornell_rays(scene, cam, n_cam=512, n_rand=512, seed=0):
    """Camera rays and random rays inside the box, [R, 3] each."""
    rng = np.random.default_rng(seed)
    p = cam.params()
    xy = rng.uniform(-1, 1, (n_cam, 2)).astype(np.float32)
    d = xy[:, :1] * p.u + xy[:, 1:] * p.v + p.w
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = np.broadcast_to(p.eye, d.shape).astype(np.float32)
    ro, rd = random_rays(n_rand, seed=seed + 1)
    return (torch.as_tensor(np.concatenate([o, ro])),
            torch.as_tensor(np.concatenate([d, rd])))


def _case(name):
    """(table, o, d, time) of a sweep case."""
    if name == "ties":
        scene, cam, _ = fused_scene("ties", "static")
        assert all((b - a) % 2 == 1 for a, b in tie_columns(scene))
        o, d = _cornell_rays(scene, cam)
        return mt.build_tri_soup(scene.geom, "cpu",
                                 num_faces=scene.num_faces), o, d, None
    if name == "two_tiles":
        geom = scattered_soup(800, 31)
        o, d = rays_at(geom, np.arange(0, 800, 7), 1024, 32)
        soup = mt.build_tri_soup(geom, "cpu", num_faces=800)
        assert soup.tris.shape[0] == 2
        return soup, torch.as_tensor(o), torch.as_tensor(d), None
    _, scene, _, cam = moving_cornell_pair()
    o, d = _cornell_rays(scene, cam, seed=4)
    tm = torch.as_tensor(np.random.default_rng(5).uniform(
        0, 1, o.shape[0]).astype(np.float32))
    return (mt.build_motion_soup(scene.geom, "cpu", scene.num_faces), o, d,
            tm)


CASES = {name: _case(name) for name in ("ties", "two_tiles", "motion")}


@pytest.mark.parametrize("count", COUNTS, ids=["none", "inside", "all"])
@pytest.mark.parametrize("name", ["cornell", "two_tiles"])
def test_real_face_sweep_matches_plain_and_reference(name, count):
    """The real-face cut of the plain sweeps is bit-equal to them, and
    both match the reference's kernels."""
    if name == "cornell":
        js, ts, o, d = (*cornell_pair()[:2], *_cornell_rays(
            cornell_pair()[1], cornell_pair()[3]))
        geom, n_faces = js.geom, js.num_faces
        soup = mt.build_tri_soup(ts.geom, "cpu", num_faces=ts.num_faces)
    else:
        soup, o, d, _ = CASES["two_tiles"]
        geom, n_faces = scattered_soup(800, 31), 800
    jsoup = j_soup(geom, num_faces=n_faces)._replace(num_faces=n_faces)
    jo, jd = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    r = -(-o.shape[0] // BLOCK) * BLOCK
    c = _count(count, r)
    for any_hit in (False, True):
        tmin, tmax = (0.001, 1.5) if any_hit else (0.01, 1e16)
        rays, _ = mt.pack_rays(o, d, tmin, tmax)
        ref = (mt.any_ref if any_hit else mt.closest_ref)(rays, c, soup)
        got = real_face_sweep(rays, c, soup, any_hit)
        assert _bits(got, ref)
        fn = j_any if any_hit else j_closest
        want = fn(jsoup, jo, jd, tmin, tmax, count=count, interpret=True)
        n = o.shape[0]
        if any_hit:
            np.testing.assert_array_equal(got[:n, 0].numpy() > 0,
                                          np.asarray(want))
        else:
            np.testing.assert_array_equal(got[:n, 1].numpy().astype(
                np.int64), np.asarray(want.prim))
            for col, key in ((0, "t"), (2, "u"), (3, "v")):
                hit = got[:n, 1].numpy() >= 0
                np.testing.assert_allclose(
                    got[:n, col].numpy()[hit],
                    np.asarray(getattr(want, key))[hit],
                    **(TOL if name == "cornell" else SOUP_TOL))
        if count == 0:
            assert not bool((got[:, 1 if not any_hit else 0]
                             > (-1 if not any_hit else 0)).any())


@pytest.mark.parametrize("g_size", [1, 2, 4])
@pytest.mark.parametrize("count", COUNTS, ids=["none", "inside", "all"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_group_sweep_matches_plain_versions(name, count, g_size):
    """The kernels' schedule (group_sweep) against the plain sweeps, every
    output bit for bit; on the ties scene the lower prim of each tie
    wins."""
    table, o, d, tm = CASES[name]
    for any_hit in (False, True):
        tmin, tmax = (0.001, 1.5) if any_hit else (0.01, 1e16)
        rays, r = mt.pack_rays(o, d, tmin, tmax)
        c = _count(count, r)
        t = None if tm is None else torch.cat(
            [tm, torch.zeros(r - tm.shape[0])])
        if tm is None:
            ref = (mt.any_ref if any_hit else mt.closest_ref)(rays, c, table)
        else:
            fn = mt.any_motion_ref if any_hit else mt.closest_motion_ref
            ref = fn(rays, t, c, table, BLOCK)
        got = group_sweep(rays, c, table, g_size, any_hit, t)
        assert _bits(got, ref)
        if name == "ties" and not any_hit and count is None:
            scene = fused_scene("ties", "static")[0]
            prims = got[:, 1].long()
            for low, high in tie_columns(scene):
                assert bool((prims == low).any())
                assert not bool((prims == high).any())
