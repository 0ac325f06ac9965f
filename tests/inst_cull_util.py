"""The scenes and rays of tests/test_torch_instanced_cull.py, in numpy and
either package's scene classes, without jax: tests/test_torch_cuda.py
builds the same inputs for K7 on the card.

`three_instances_parts` takes a package's `builtin` module, `Material`,
`Mesh` and `Instance`, `ties_parts` the last three; both return (meshes,
instances) for that package's `build_instanced_scene`. The ray builders
take a numpy Generator and return float32 (o, d, tmax)."""
import numpy as np

N = 1000
COUNT_IN_TILE = 700  # the last ray tile skipped, rays 700-767 traced


def xform(translate=(0.0, 0.0, 0.0)):
    t = np.zeros((3, 4), np.float32)
    t[:, :3] = np.eye(3)
    t[:, 3] = translate
    return t


def ties_parts(Material, Mesh, Instance):
    """Two identical instances of a 131-face mesh at one place and one
    behind them. Face 0 is a right triangle in z = 0, repeated as face
    128 (the second tile); face 5 and face 130, the last, are degenerate
    (collinear, not all zero); the rest are random triangles behind."""
    rng = np.random.default_rng(5)
    tri0 = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    degen = np.asarray([[0, 0, 0.5], [0.25, 0.25, 0.5], [0.5, 0.5, 0.5]],
                       np.float32)
    tris = [tri0]
    for f in range(1, 131):
        if f in (5, 130):
            tris.append(degen)
        elif f == 128:
            tris.append(tri0)
        else:
            c = rng.uniform([-1, -1, -2.0], [2, 2, -0.8], 3)
            tris.append((c + rng.normal(0, 0.3, (3, 3))).astype(np.float32))
    v = np.concatenate(tris).astype(np.float32)
    mesh = Mesh(vertices=v[None],
                indices=np.arange(len(v), dtype=np.int32).reshape(-1, 3),
                material=Material(diffuse=(0.7, 0.7, 0.7)))
    inst = [Instance(mesh_index=0), Instance(mesh_index=0),
            Instance(mesh_index=0, transforms=xform((0.0, 0.0, -0.5)))]
    return [mesh], inst


def three_instances_parts(builtin, Material, Mesh, Instance):
    """The reference test's scene (tests/test_pallas_instanced.py:24-37,
    as tests/test_torch_instanced_mt.py copies it): a box placed twice,
    once scaled by 0.5, and a lamp."""
    white = Material(diffuse=(0.7, 0.7, 0.7))
    light = Material(emissive=(12.0, 12.0, 12.0))
    box = builtin.box_mesh([-0.3, 0.0, -0.3], [0.3, 0.6, 0.3], white)
    lv, lf = builtin.quad([-0.4, 2.0, -0.4], [-0.4, 2.0, 0.4],
                          [0.4, 2.0, 0.4], [0.4, 2.0, -0.4])
    lamp = Mesh(vertices=lv[None], indices=lf, material=light)
    half = xform((0.7, 0.0, 0.0))
    half[:, :3] *= 0.5
    return [box, lamp], [Instance(mesh_index=0,
                                  transforms=xform((-0.7, 0.0, 0.0))),
                         Instance(mesh_index=0, transforms=half),
                         Instance(mesh_index=1)]


def unit(d):
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def seeded(rng, n, lo, hi):
    return (rng.uniform(lo, hi, (n, 3)),
            unit(rng.normal(size=(n, 3))), rng.uniform(0.1, 3.0, n))


def zero_box_rays(rng, planes, edges, n=40):
    """Rays in planes (axis, value) of zero-thickness boxes, random in the
    plane, and along edges ((axis, value), (axis, value)) of them, each
    way along the third axis."""
    o, d = [], []
    for axis, value in planes:
        oo = rng.uniform(-1.3, 1.3, (n, 3))
        oo[:, axis] = value
        dd = rng.normal(size=(n, 3))
        dd[:, axis] = 0.0
        o.append(oo)
        d.append(dd)
    for (a0, v0), (a1, v1) in edges:
        oo = rng.uniform(-1.2, 1.2, (n, 3))
        oo[:, a0], oo[:, a1] = v0, v1
        dd = np.zeros((n, 3))
        dd[:, 3 - a0 - a1] = np.where(rng.uniform(size=n) < 0.5, -1.0, 1.0)
        o.append(oo)
        d.append(dd)
    return np.concatenate(o), unit(np.concatenate(d))


def cornell_rays(rng):
    """Rays in the planes of the zero-thickness boxes of the Cornell's
    light (y = 1.99) and of its nine small floors (y = 0.2) and along
    their edges, rays with one or two zero direction components and rays
    with tmax <= tmin; seeded rays fill to N. (Rays in the planes of the
    big walls meet the other walls on their edges: WALL_RAYS.)"""
    o, d = zero_box_rays(
        rng, [(1, 1.99), (1, 0.2)],
        [((1, 1.99), (2, -0.4)), ((1, 1.99), (0, 0.4)),
         ((1, 0.2), (0, -0.35)), ((1, 0.2), (2, 0.85)),
         ((1, 0.2), (0, 0.25))])
    o, d = [o], [d]
    n = 40
    # one and two zero direction components from inside the box
    for zeros in ((0,), (1,), (2,), (0, 2), (0, 1), (1, 2)):
        oo = rng.uniform([-0.9, 0.05, -0.9], [0.9, 1.9, 0.9], (n, 3))
        dd = rng.normal(size=(n, 3))
        dd[:, list(zeros)] = 0.0
        o.append(oo)
        d.append(unit(dd))
    k = sum(len(x) for x in o)
    tmax = [rng.uniform(0.1, 4.0, k)]
    # tmax <= tmin (tmin is 1e-3): equal, below, negative
    oo, dd, _ = seeded(rng, n, [-0.9, 0.05, -0.9], [0.9, 1.9, 0.9])
    o.append(oo)
    d.append(dd)
    tmax.append(rng.choice([1e-3, 5e-4, -1.0, 0.0], n))
    oo, dd, tt = seeded(rng, N - k - n, [-0.9, 0.05, -0.9],
                         [0.9, 1.9, 0.9])
    o.append(oo)
    d.append(dd)
    tmax.append(tt)
    return (np.concatenate(o).astype(np.float32),
            np.concatenate(d).astype(np.float32),
            np.concatenate(tmax).astype(np.float32))


def ties_rays(rng):
    """Rays from z = 2 at the shared face 0 of the identical instances
    (straight, then tilted), long enough to reach it, then seeded rays."""
    m = N // 2
    o = np.zeros((m, 3))
    o[:, :2] = rng.uniform(-0.1, 0.7, (m, 2))
    o[:, 2] = 2.0
    d = np.tile([0.0, 0.0, -1.0], (m, 1))
    d[m // 2:, :2] = rng.normal(0, 0.05, (m - m // 2, 2))
    o2, d2, _ = seeded(rng, N - m, [-1, -1, -1], [2, 2, 2])
    return (np.concatenate([o, o2]).astype(np.float32),
            unit(np.concatenate([d, d2])).astype(np.float32),
            np.concatenate([rng.uniform(2.2, 4.0, m),
                            rng.uniform(0.1, 4.0, N - m)]).astype(np.float32))


def three_rays(rng):
    o, d, t = seeded(rng, N, [-1.5, 0.1, -1.5], [1.5, 1.8, 1.5])
    return o.astype(np.float32), unit(d).astype(np.float32), \
        t.astype(np.float32)


def wall_rays(rng):
    """Rays in the planes of the Cornell's walls (x = +-1, y = 0, y = 2,
    z = -1) and along their edges."""
    o, d = zero_box_rays(
        rng, [(0, -1.0), (0, 1.0), (1, 0.0), (1, 2.0), (2, -1.0)],
        [((0, -1.0), (1, 0.0)), ((0, 1.0), (1, 2.0)), ((1, 0.0), (2, -1.0)),
         ((0, -1.0), (2, -1.0))], n=100)
    return (o.astype(np.float32), d.astype(np.float32),
            rng.uniform(0.1, 4.0, len(o)).astype(np.float32))
