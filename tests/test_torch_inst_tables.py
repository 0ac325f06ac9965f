"""The instanced walk's host tables in the port: split_order_instanced's
orders, build_inst_hier_table (fanout 16, 20 and the bf16-packed 32, auto
and forced) and build_baked_world_table are array-equal to the
reference's (tolerance: none); the fanout resolves by depth as the
reference's does; the baked rule admits static fields only."""
import numpy as np
import pytest

from inst_util import j_field, j_multi_instance_cornell, to_port_iscene
from rendertoy3c_tpu.trace import hier_instanced as jhi
from rendertoy3c_tpu.trace.hierwalk import _bf16_outward as j_bf16
from rendertoy3c_tpu_torch.trace import hier_instanced as hi
from rendertoy3c_tpu_torch.trace.hierwalk import (FANOUT, FANOUT20, FANOUT32,
                                                  _bf16_outward)


def _j_deep(n_inst=18, grid_n=43):
    """The reference's deep instance field (tests/test_hier_instanced.py
    :320-360): 5 levels at fanout 16; n_inst 25 and grid_n 55 need 32."""
    from test_hier_instanced import _deep_instance_field

    return _deep_instance_field(n_inst=n_inst, grid_n=grid_n)


def _scene(name):
    if name == "cornell9":
        return j_multi_instance_cornell()[0]
    if name == "field_2key":
        return j_field(True, 24)[0]
    if name == "deep20":
        return _j_deep()
    return _j_deep(25, 55)


def _assert_scene_equal(ts, js):
    for k in ("v0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
              "mat_id"):
        np.testing.assert_array_equal(getattr(ts.geom, k),
                                      np.asarray(getattr(js.geom, k)), k)
    for k in ts.instances._fields:
        np.testing.assert_array_equal(getattr(ts.instances, k),
                                      np.asarray(getattr(js.instances, k)), k)
    assert ts.instance_mesh == js.instance_mesh


def _assert_table_equal(tt, jt):
    np.testing.assert_array_equal(tt.table.numpy(), np.asarray(jt.table))
    assert (tt.world_starts, tt.inst_start, tt.mesh_starts, tt.leaf_start,
            tt.num_faces, tt.motion, tt.fanout) == (
        jt.world_starts, jt.inst_start, jt.mesh_starts, jt.leaf_start,
        jt.num_faces, jt.motion, jt.fanout)


def test_bf16_outward_equals_reference():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4096) * np.exp(rng.uniform(-20, 20, 4096))
         ).astype(np.float32)
    x = np.concatenate([x, np.float32([1e30, -1e30, 0.0, -0.0, 1.0])])
    for up in (False, True):
        np.testing.assert_array_equal(_bf16_outward(x, up),
                                      j_bf16(x, up).view(np.uint16))


@pytest.mark.parametrize("name, fanout", [
    ("cornell9", FANOUT), ("deep20", FANOUT20), ("deep32", FANOUT32),
    ("field_2key", FANOUT32)])
def test_fanout_resolves_as_reference(name, fanout):
    js = _scene(name)
    ts = to_port_iscene(js)
    assert hi._resolve_inst_fanout(ts) == jhi._resolve_inst_fanout(js) \
        == fanout


@pytest.mark.parametrize("name", ["cornell9", "deep20", "deep32",
                                  "field_2key"])
def test_split_order_and_table_array_equal(name):
    """The split order (faces within each mesh, instances by their world
    boxes) and the auto-fanout table; the 578-instance 2-key field takes
    the bf16 32-wide rows: world levels at rows 0-1, mesh levels at 598
    and 599, leaves from 603 (675 rows)."""
    js = _scene(name)
    jo = jhi.split_order_instanced(js)
    to = hi.split_order_instanced(to_port_iscene(js))
    _assert_scene_equal(to, jo)
    tt = hi.build_inst_hier_table(to, device="cpu")
    _assert_table_equal(tt, jhi.build_inst_hier_table(jo))
    if name == "field_2key":
        assert tt.table.shape[0] == 675 and tt.fanout == FANOUT32
        assert (tt.world_starts, tt.mesh_starts, tt.leaf_start) == (
            (0, 1), (598, 599), 603)


@pytest.mark.parametrize("fanout", [FANOUT, FANOUT20, FANOUT32])
def test_forced_fanout_tables_array_equal(fanout):
    jo = jhi.split_order_instanced(_j_deep())
    to = hi.split_order_instanced(to_port_iscene(jo))
    _assert_table_equal(
        hi.build_inst_hier_table(to, fanout=fanout, device="cpu"),
        jhi.build_inst_hier_table(jo, fanout=fanout))


@pytest.mark.parametrize("grid", [4, 24])
def test_baked_world_table_array_equal(grid):
    """The static field's baked table and stride; at grid 24 (578
    instances, 1280 stored faces) the ids stay f32-exact: 578 * 1280 <
    2^24."""
    jo = jhi.split_order_instanced(j_field(False, grid)[0])
    to = hi.split_order_instanced(to_port_iscene(jo))
    assert hi.baked_world_eligible(to) and jhi.baked_world_eligible(jo)
    tt, ts = hi.build_baked_world_table(to, device="cpu")
    jt, jst = jhi.build_baked_world_table(jo)
    assert ts == jst == to.geom.mat_id.shape[0]
    np.testing.assert_array_equal(tt.table.numpy(), np.asarray(jt.table))
    assert (tt.level_starts, tt.leaf_start, tt.num_faces, tt.fanout) == (
        jt.level_starts, jt.leaf_start, jt.num_faces, jt.fanout)
    if grid == 24:
        assert tt.num_faces == 578 * 1280 < 1 << 24
        assert tt.table.shape[0] == 42802 and tt.n_levels == 5


def test_baked_rule():
    """Static fields bake; 2-key fields walk the space-switching table;
    a field whose ids pass 2^24 does not bake."""
    static = to_port_iscene(j_field(False, 4)[0])
    assert hi.baked_world_eligible(static)
    assert not hi.baked_world_eligible(to_port_iscene(j_field(True, 4)[0]))
    import dataclasses

    many = dataclasses.replace(static, num_instances=(1 << 24) // 1280 + 1)
    assert not hi.baked_world_eligible(many)


def test_baked_table_refuses_2key():
    """build_baked_world_table takes static scenes only, as
    baked_world_eligible admits them."""
    motion = hi.split_order_instanced(to_port_iscene(j_field(True, 4)[0]))
    with pytest.raises(ValueError, match="static scenes only"):
        hi.build_baked_world_table(motion, device="cpu")
