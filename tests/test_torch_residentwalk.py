"""The resident-table walk (K8) of the port: its tables array-equal to
the reference's, its plain version (trace/residentwalk.py
walk_closest_ref / walk_any_ref, through trace_closest_walk /
trace_any_walk) against the reference's Pallas kernels in interpret mode
on the cases of tests/test_pallas_walk.py, and both against the port's
brute tracer.

Prims, occlusion and the cursor rows are exact. t, u and v hold at rtol
= atol = 1e-6, not bit for bit: on the grazing rays about half of the u
values differ in the last bits, where XLA's CPU compiler evaluates the
interpret-mode kernel's float expressions in its own way (contracted
multiply-adds, its reciprocal), as for K1 in tests/test_torch_mt.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendertoy3c_tpu.accel.lbvh import split_order_scene as j_split_order
from rendertoy3c_tpu.scene.builtin import box_mesh as j_box_mesh
from rendertoy3c_tpu.scene.material import Material as JMaterial
from rendertoy3c_tpu.scene.mesh import Mesh as JMesh
from rendertoy3c_tpu.scene.scene import build_scene as j_build_scene
from rendertoy3c_tpu.trace import leafwalk as j_leafwalk
from rendertoy3c_tpu.trace import pallas_walk as j_walk
from rendertoy3c_tpu_torch.accel.lbvh import split_order_scene
from rendertoy3c_tpu_torch.scene.scene import build_scene
from rendertoy3c_tpu_torch.trace import leafwalk, residentwalk
from rendertoy3c_tpu_torch.trace.intersect import trace_closest_bruteforce
from resident_walk_util import (check_closest, field_pair, grazing, rays,
                                tables)
from torch_port_util import cornell_pair


@pytest.fixture(scope="module")
def cornell():
    js, ts, _, _ = cornell_pair()
    return js, ts


@pytest.fixture(scope="module")
def field():
    return field_pair()


@pytest.mark.parametrize("which,leaf", [("cornell", 128), ("field", 32),
                                        ("field", 64), ("field", 128)])
def test_tables_array_equal(which, leaf, cornell, field):
    js, ts = cornell if which == "cornell" else field
    jl = j_leafwalk.build_leaf_table(js.geom, leaf=leaf)
    tl = leafwalk.build_leaf_table(ts.geom, leaf=leaf)
    np.testing.assert_array_equal(tl.rows, np.asarray(jl.rows))
    np.testing.assert_array_equal(tl.aabb_t, np.asarray(jl.aabb_t))
    assert tl.num_faces == jl.num_faces == ts.geom.v0.shape[1]
    jt, tt = tables(js, ts, leaf)
    np.testing.assert_array_equal(tt.rows.numpy(), np.asarray(jt.rows))
    np.testing.assert_array_equal(tt.aabb_lanes.numpy(),
                                  np.asarray(jt.aabb_lanes))
    assert (tt.num_faces, tt.leaf, tt.n_leaves) == (
        jt.num_faces, jt.leaf, jt.n_leaves)
    # padding lanes and empty leaves carry the far point-box
    assert (tt.aabb_lanes[:6, tt.n_leaves:] == 1e30).all()


def test_bench_field_tables_array_equal():
    """bench.py's 49k box field (`_box_field_scene`) after
    split_order_scene, at the walk's 128-face leaves."""
    from rendertoy3c_tpu.scene.builtin import quad as j_quad
    from rendertoy3c_tpu_torch.scene.builtin import box_field

    jm, _ = box_field(64, j_box_mesh, j_quad, JMaterial, JMesh)
    tm, _ = box_field(64)
    js = j_split_order(j_build_scene(jm))
    ts = split_order_scene(build_scene(tm))
    assert ts.num_faces == js.num_faces > 49000
    jl = j_leafwalk.build_leaf_table(js.geom, leaf=128)
    tl = leafwalk.build_leaf_table(ts.geom, leaf=128)
    np.testing.assert_array_equal(tl.rows, np.asarray(jl.rows))
    np.testing.assert_array_equal(tl.aabb_t, np.asarray(jl.aabb_t))
    jt, tt = tables(js, ts, 128)
    np.testing.assert_array_equal(tt.aabb_lanes.numpy(),
                                  np.asarray(jt.aabb_lanes))


CLOSEST_CASES = {
    # (scene, ray box, seed, n, leaf, rt, t_rounds, tmin)
    "cornell": ("cornell", ([-0.9, 0.05, -0.9], [0.9, 1.9, 0.9]), 0, 256,
                128, 32, 24),
    "field_small_leaf": ("field", ([-1, 0.1, -1], [9, 2.5, 9]), 5, 192, 32,
                         16, 24),
    "field_grazing": ("field", None, 11, 128, 64, 8, 24),
    "field_forced_passes": ("field", ([-1, 0.1, -1], [9, 2.5, 9]), 13, 200,
                            32, 32, 2),
    "field_r_not_multiple": ("field", ([-1, 0.1, -1], [9, 2.5, 9]), 17, 77,
                             64, 32, 24),
}


@pytest.mark.parametrize("case", sorted(CLOSEST_CASES))
def test_closest_matches_reference(case, cornell, field):
    which, box, seed, n, leaf, rt, t_rounds = CLOSEST_CASES[case]
    js, ts = cornell if which == "cornell" else field
    o, d = grazing(n, seed) if box is None else rays(n, *box, seed)
    jt, tt = tables(js, ts, leaf)
    want = j_walk.trace_closest_walk(jt, jnp.asarray(o), jnp.asarray(d),
                                     0.01, 1e16, rt=rt, t_rounds=t_rounds,
                                     interpret=True)
    passes = []
    got = residentwalk.trace_closest_walk(
        tt, torch.as_tensor(o), torch.as_tensor(d), 0.01, 1e16, rt=rt,
        t_rounds=t_rounds, passes=passes)
    brute = trace_closest_bruteforce(ts, torch.as_tensor(o),
                                     torch.as_tensor(d), 0.01, 1e16)
    check_closest(got, want, brute)
    if case == "field_forced_passes":
        assert int(passes[0][:, 0].max()) > 1  # the residual passes ran
