"""The hierwalk band's scene order and node tables against the reference.

accel/lbvh.py `split_order_scene` gives the reference's face permutation
(the scene SoA array-equal after the reorder) on Cornell at leaf 14, on a
box field whose variable ordering is kept (fill >= 0.8) at leaves 14 and
7, on tests/test_walkpool.py:265-292's 40 x 40 grid (19202 faces; its
variable ordering fills 0.857 and is kept too) and on the 4294-face town,
whose variable ordering falls under the fill rule and snaps. The
reference's SAH order comes from its native build where the library loads
(bit-identical to its numpy recursion, tests/test_native.py), which the
port's numpy recursion must then equal too. trace/hierwalk.py
`build_hier_table` is array-equal to the reference's (table, level
starts, leaf start, fanout) for static and 2-key scenes, fanout 16, 20
and auto, on scenes of 3 directory levels."""
import numpy as np
import pytest

from rendertoy3c_tpu.accel.lbvh import split_order_scene as j_split_order
from rendertoy3c_tpu.trace import hierwalk as jh
from rendertoy3c_tpu_torch.accel.lbvh import split_order_scene
from rendertoy3c_tpu_torch.scene.town import town_scene
from rendertoy3c_tpu_torch.trace import hierwalk as th
from torch_port_util import (box_field_pair, cornell_pair, j_town_scene,
                             lit_grid_scene, to_port_hier_table)


def _assert_same_order(js, ts):
    assert js.num_faces == ts.num_faces
    for name in ("v0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
                 "mat_id"):
        np.testing.assert_array_equal(getattr(ts.geom, name),
                                      np.asarray(getattr(js.geom, name)),
                                      err_msg=name)


@pytest.mark.parametrize("case, leaf, kept", [
    ("cornell", 14, None), ("box_field", 14, True), ("box_field", 7, True)])
def test_split_order_matches_reference(case, leaf, kept):
    if case == "cornell":
        js, ts = cornell_pair()[:2]
    else:
        js, ts, _ = box_field_pair(16)
    f = ts.num_faces
    j2, t2 = j_split_order(js, leaf=leaf), split_order_scene(ts, leaf=leaf)
    _assert_same_order(j2, t2)
    if kept:  # the variable ordering: degenerate padding faces added
        assert t2.num_faces > f and f / t2.num_faces >= 0.8


@pytest.mark.parametrize("case", ["grid40", "town"])
def test_split_order_of_larger_scenes(tmp_path, case):
    """The 40 x 40 grid keeps its variable ordering (19202 faces padded to
    22414); the town's fills under 0.8 and snaps (num_faces unchanged)."""
    if case == "grid40":
        js, ts = lit_grid_scene("jax"), lit_grid_scene("torch")
        faces, ordered = 19202, 22414
    else:
        js = j_town_scene(4000, False, tmp_path)[0]
        ts = town_scene(4000)[0]
        faces = ordered = 4294
    assert ts.num_faces == faces
    j2, t2 = (j_split_order(js, leaf=th.HIER_LEAF),
              split_order_scene(ts, leaf=th.HIER_LEAF))
    _assert_same_order(j2, t2)
    assert t2.num_faces == ordered


@pytest.fixture(scope="module")
def ordered():
    """{two_key: (reference scene, port scene)} of the 24 x 24 box field,
    split-ordered at its leaf size."""
    out = {}
    for motion in (False, True):
        js, ts, _ = box_field_pair(24, motion)
        leaf = th.HIER_LEAF_MOTION if motion else th.HIER_LEAF
        out[motion] = (j_split_order(js, leaf=leaf),
                       split_order_scene(ts, leaf=leaf))
    return out


@pytest.mark.parametrize("fanout", [0, 16, 20])
@pytest.mark.parametrize("motion", [False, True], ids=["static", "2key"])
def test_hier_table_matches_reference(ordered, motion, fanout):
    js, ts = ordered[motion]
    keys = 2 if motion else 1
    jt = jh.build_hier_table(js.geom, js.num_faces, num_keys=keys,
                             fanout=fanout)
    tt = th.build_hier_table(ts.geom, ts.num_faces, num_keys=keys,
                             fanout=fanout)
    assert tt.n_levels == len(jt.level_starts) >= 3
    assert (tt.level_starts, tt.leaf_start, tt.fanout, tt.num_faces) == (
        tuple(jt.level_starts), jt.leaf_start, jt.fanout, jt.num_faces)
    np.testing.assert_array_equal(tt.table.numpy(), np.asarray(jt.table))
    carried = to_port_hier_table(jt)
    assert carried.level_bounds() == tt.level_bounds()
