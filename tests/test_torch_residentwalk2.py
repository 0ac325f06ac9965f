"""The resident-table walk (K8), continued: the plain any-hit walk
against the reference's interpret-mode kernel and the brute tracer, the
live-count gate, one launch's output and cursor rows in chained
launches, and make_walk_tracer. Tolerances as in
tests/test_torch_residentwalk.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendertoy3c_tpu.trace import pallas_walk as j_walk
from rendertoy3c_tpu_torch.trace import residentwalk
from rendertoy3c_tpu_torch.trace.intersect import (trace_any_bruteforce,
                                                   trace_closest_bruteforce)
from resident_walk_util import TOL, check_closest, field_pair, rays, tables
from torch_port_util import cornell_pair


@pytest.fixture(scope="module")
def cornell():
    js, ts, _, _ = cornell_pair()
    return js, ts


@pytest.fixture(scope="module")
def field():
    return field_pair()


@pytest.mark.parametrize("leaf,rt,t_rounds", [(64, 16, 24), (32, 32, 2),
                                              (128, 8, 24)])
def test_any_matches_reference(leaf, rt, t_rounds, field):
    js, ts = field
    o, d = rays(256, [-1, 0.1, -1], [9, 2.5, 9], 7)
    jt, tt = tables(js, ts, leaf)
    for tmax in (0.5, 3.0, 1e16):
        want = j_walk.trace_any_walk(jt, jnp.asarray(o), jnp.asarray(d),
                                     0.001, tmax, rt=rt, t_rounds=t_rounds,
                                     interpret=True)
        got = residentwalk.trace_any_walk(
            tt, torch.as_tensor(o), torch.as_tensor(d), 0.001, tmax, rt=rt,
            t_rounds=t_rounds)
        brute = trace_any_bruteforce(ts, torch.as_tensor(o),
                                     torch.as_tensor(d), 0.001, tmax)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), brute.numpy())


def test_count_gates_live_rays(cornell):
    """Rays past `count` inside a live block still steer the walk; the
    per-ray gate after it drops their hits (pallas_walk.py:427-430)."""
    js, ts = cornell
    o, d = rays(64, [-0.9, 0.05, -0.9], [0.9, 1.9, 0.9], 9)
    jt, tt = tables(js, ts, 128)
    for count in (10, 40):
        want = j_walk.trace_closest_walk(
            jt, jnp.asarray(o), jnp.asarray(d), 0.01, 1e16, count=count,
            rt=8, interpret=True)
        got = residentwalk.trace_closest_walk(
            tt, torch.as_tensor(o), torch.as_tensor(d), 0.01, 1e16,
            count=torch.tensor(count), rt=8)
        np.testing.assert_array_equal(got.prim.numpy(),
                                      np.asarray(want.prim))
        assert (got.prim.numpy()[count:] == -1).all()
        occ_w = j_walk.trace_any_walk(jt, jnp.asarray(o), jnp.asarray(d),
                                      0.001, 1e16, count=count, rt=8,
                                      interpret=True)
        occ = residentwalk.trace_any_walk(tt, torch.as_tensor(o),
                                          torch.as_tensor(d), 0.001, 1e16,
                                          count=count, rt=8)
        np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_w))
        assert not occ.numpy()[count:].any()


def test_one_launch_rows_and_cursor(field):
    """One launch's output rows and cursor rows against the reference's
    kernel, from a cursor in mid-walk (a forced 2-round launch): the
    cursor rows bit-equal, prims and occlusion exact."""
    js, ts = field
    o, d = rays(128, [-1, 0.1, -1], [9, 2.5, 9], 21)
    jt, tt = tables(js, ts, 32)
    packed, _ = residentwalk._pack(torch.as_tensor(o), torch.as_tensor(d),
                                 0.01, 1e16, 32)
    count = torch.tensor([100], dtype=torch.int32)
    er, ir = residentwalk._start(packed, 32)
    for any_hit in (False, True):
        ref_fn = j_walk._any_kernel if any_hit else j_walk._closest_kernel
        fn = (residentwalk.walk_any_ref if any_hit
              else residentwalk.walk_closest_ref)
        cur_er, cur_ir = er, ir
        for _ in range(3):  # three chained launches
            want_out, want_cur = j_walk._walk_call(
                ref_fn, jnp.asarray(count.numpy()),
                jnp.asarray(cur_er.numpy()), jnp.asarray(cur_ir.numpy()),
                jnp.asarray(packed.numpy()), jt, 32, 2, True)
            out, cur = fn(count, cur_er, cur_ir, packed, tt, 32, 2)
            np.testing.assert_array_equal(cur.numpy(), np.asarray(want_cur))
            np.testing.assert_array_equal(out[:, 1].numpy(),
                                          np.asarray(want_out)[:, 1])
            np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                                       **TOL)
            cur_er, cur_ir = cur[:, 1].contiguous(), cur[:, 2].to(torch.int32)


def test_make_walk_tracer_contract(field):
    js, ts = field
    closest, any_hit = residentwalk.make_walk_tracer(ts, "cpu")
    jc, ja = j_walk.make_walk_tracer(js, interpret=True)
    o, d = rays(96, [-1, 0.1, -1], [9, 2.5, 9], 13)
    ot, dt = torch.as_tensor(o), torch.as_tensor(d)
    got = closest(ot, dt, 0.01, 1e16, 0.0)
    want = jc(jnp.asarray(o), jnp.asarray(d), 0.01, 1e16, 0.0)
    check_closest(got, want, trace_closest_bruteforce(ts, ot, dt, 0.01,
                                                       1e16))
    np.testing.assert_array_equal(
        any_hit(ot, dt, 0.001, 2.0, 0.0).numpy(),
        np.asarray(ja(jnp.asarray(o), jnp.asarray(d), 0.001, 2.0, 0.0)))
    from torch_port_util import moving_cornell_pair

    with pytest.raises(ValueError, match="static"):
        residentwalk.make_walk_tracer(moving_cornell_pair()[1], "cpu")
    assert residentwalk.max_walk_faces() == j_walk.max_walk_faces()
