"""K4's plain version (trace_shade_refill_ref) against the reference refill
megakernel in interpret mode, teacher-forced: both get the same state at
every launch (the reference's output of the launch before).

Cornell 16x16, 2 spp, depth 4, pool 512, 8 launches, static and (the
motion variant) the 2-key Cornell box; and the textured variant on the
textured quad with CLAMP/MIRROR, a uv transform and a normal map, and on
the 2-key textured quad. Stats exact, and for motion the
time buffer exact: the time drawn for every lane at the end of a launch,
which advances the seed of live lanes only, while the shadow sweep's time
is a peek that leaves it. The integer-valued columns exact and the float
columns within rtol = atol = 3e-5 on at least 98% of lanes (last-ulp
differences of sqrt/cos between XLA and torch may flip one lane's Russian
roulette)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendertoy3c_tpu.integrate.config import RenderConfig as JConfig
from rendertoy3c_tpu.trace.pallas_shade import make_fused_shader
from rendertoy3c_tpu.trace.pallas_mt import build_tri_soup as j_soup
from rendertoy3c_tpu_torch.integrate.config import RenderConfig
from rendertoy3c_tpu_torch.trace import shade
from torch_port_util import (cornell_pair, moving_cornell_pair,
                             textured_quad_pair)

CFG = dict(width=16, height=16, samples_per_launch=2, max_depth=4,
           ray_block=512, integrator="pool", pool_pixel_major=True)
POOL, N_PIX, SUB = 512, 256, 1
INT_COLS = [0, 8, 9, 13, 14, 15]  # seed bits, depth, alive, pixel, samp, shadow
FLOAT_COLS = [c for c in range(16) if c not in INT_COLS]


def _initial_state(pool):
    misc = np.zeros((pool, 16), np.float32)
    misc[:, 13] = -1.0
    stash = np.zeros((pool, 16), np.float32)
    stash[:, 0] = -1.0
    return np.zeros((pool, 8), np.float32), misc, stash


def _scf(cam):
    p = cam.params()
    return np.concatenate([p.eye, p.u, p.v, p.w]).astype(np.float32)


def _lane_match(got, want, cols, exact):
    """Fraction of lanes whose given columns agree."""
    if exact:
        ok = got[:, cols].view(np.uint32) == want[:, cols].view(np.uint32)
    else:
        ok = np.isclose(got[:, cols], want[:, cols], rtol=3e-5, atol=3e-5)
    return ok.all(axis=1).mean()


def _launches(motion, scenes=None):
    """8 teacher-forcing steps of the reference: (port scene, port camera,
    [(inputs, outputs)]); a motion step's time8 [P, 8] enters and leaves
    as its column 0. scenes: a (reference, port) scene and camera pair,
    by default the (2-key) Cornell box."""
    js, ts, jcam, tcam = scenes or (moving_cornell_pair() if motion
                                    else cornell_pair())
    soup = j_soup(js.geom, num_faces=js.num_faces)._replace(
        num_faces=js.num_faces)
    soup1 = (j_soup(js.geom, key=1, num_faces=js.num_faces)._replace(
        num_faces=js.num_faces) if motion else None)
    kern = make_fused_shader(js, JConfig(**CFG), soup, soup1, interpret=True,
                             merged=True,
                             refill=dict(n_pix=N_PIX, use_stash=True))
    rays, misc, stash = _initial_state(POOL)
    time = np.zeros(POOL, np.float32)
    next_work, count = 0, 0
    steps = []
    for _ in range(8):
        sci = np.array([next_work, 0, SUB, 0], np.int32)
        time8 = (jnp.asarray(np.repeat(time[:, None], 8, axis=1)),) \
            if motion else ()
        outs = kern(jnp.asarray(rays), jnp.asarray(misc), jnp.asarray(stash),
                    count, sci, _scf(jcam), *time8)
        outs = [np.asarray(x) for x in outs]
        if motion:  # every column of time8 holds the lane's time
            assert (outs[3] == outs[3][:, :1]).all()
            outs[3] = outs[3][:, 0]
        else:
            outs.insert(3, None)
        steps.append(((rays, misc, stash, next_work, count, time),
                      tuple(outs)))
        rays, misc, stash = outs[0].copy(), outs[1].copy(), outs[2].copy()
        if motion:
            time = outs[3].copy()
        next_work, count = int(outs[4][0]), int(outs[4][1])
    return ts, tcam, steps


@pytest.fixture(scope="module")
def reference_launches():
    return _launches(motion=False)


@pytest.fixture(scope="module")
def motion_launches():
    return _launches(motion=True)


def _run_port(ts, tcam, inputs, device, fn):
    """[rays, misc, stash, stats, time] after one port launch."""
    rays, misc, stash, next_work, count, time = inputs
    pipe = shade.FusedPipeline(ts, RenderConfig(**CFG), device, refill_fn=fn)
    shader = pipe.refill_shader(N_PIX)
    t = [torch.as_tensor(a.copy(), device=device) for a in (rays, misc, stash)]
    tm = torch.as_tensor(time.copy(), device=device) if pipe.motion else None
    stats_in = torch.tensor([next_work, count, 0, 0], dtype=torch.int32,
                            device=device)
    stats_out = torch.zeros(4, dtype=torch.int32, device=device)
    shader(*t, stats_in, stats_out, 0, SUB, tuple(map(float, _scf(tcam))), tm)
    return [x.cpu().numpy() for x in t] + [
        stats_out.cpu().numpy(), None if tm is None else tm.cpu().numpy()]


@pytest.mark.parametrize("step", range(8))
def test_refill_ref_matches_reference_kernel(reference_launches, step):
    ts, tcam, steps = reference_launches
    inputs, want = steps[step]
    got = _run_port(ts, tcam, inputs, "cpu", shade.trace_shade_refill)
    np.testing.assert_array_equal(got[3], want[4])  # stats
    assert _lane_match(got[1], want[1], INT_COLS, exact=True) >= 0.98
    assert _lane_match(got[1], want[1], FLOAT_COLS, exact=False) >= 0.98
    assert _lane_match(got[0], want[0], list(range(8)), exact=False) >= 0.98
    assert _lane_match(got[2], want[2], list(range(16)), exact=False) >= 0.98


def test_teacher_forcing_covers_the_refill_epilogue(reference_launches):
    """The 8 steps see claims, finished samples and stash retirement."""
    _, _, steps = reference_launches
    stats = np.array([out[4] for _, out in steps])
    assert stats[0, 0] == N_PIX  # 512 idle lanes, claims clamped at 256
    assert (stats[:, 2] > 0).all()
    assert any((out[2][:, 0] >= 0).any() for _, out in steps)


@pytest.mark.parametrize("step", range(8))
def test_motion_refill_ref_matches_reference_kernel(motion_launches, step):
    ts, tcam, steps = motion_launches
    inputs, want = steps[step]
    got = _run_port(ts, tcam, inputs, "cpu", shade.trace_shade_refill)
    np.testing.assert_array_equal(got[3], want[4])  # stats
    np.testing.assert_array_equal(got[4].view(np.uint32),
                                  want[3].view(np.uint32))  # time buffer
    assert _lane_match(got[1], want[1], INT_COLS, exact=True) >= 0.98
    assert _lane_match(got[1], want[1], FLOAT_COLS, exact=False) >= 0.98
    assert _lane_match(got[0], want[0], list(range(8)), exact=False) >= 0.98
    assert _lane_match(got[2], want[2], list(range(16)), exact=False) >= 0.98


def test_motion_time_draw_advances_live_lanes_only(motion_launches):
    """The time of launch k + 1 is the unit of one LCG step of the lane's
    seed before the draw: a live lane's stored seed is that step (the draw
    advanced it), a dead lane's seed is the state the draw peeked from.
    (The shadow sweep's time is a peek too: the exact seed bits of the
    test above would break if it advanced the seed.)"""
    from rendertoy3c_tpu_torch.math import rng

    _, _, steps = motion_launches
    for _, out in steps:
        seed = rng.bits_to_state(torch.tensor(out[1][:, 0]))
        alive = torch.as_tensor(out[1][:, 9] > 0)
        drawn_from_seed = rng.rnd(seed)[1].numpy()
        assert (out[3][alive.numpy()]
                != drawn_from_seed[alive.numpy()]).any()
        live_time = (seed & 0x00FFFFFF).to(torch.float32).numpy() / 2**24
        np.testing.assert_array_equal(out[3][alive.numpy()],
                                      live_time[alive.numpy()])
        np.testing.assert_array_equal(out[3][~alive.numpy()],
                                      drawn_from_seed[~alive.numpy()])
    assert any((out[3] > 0).any() for _, out in steps)


@pytest.mark.parametrize("variant, motion", [("features", False),
                                             ("repeat", True)])
def test_textured_refill_ref_matches_reference_kernel(variant, motion):
    """Textured K4 (make_fused_shader's textured=True megakernel): the 8
    launches as above, stats (and the time buffer) exact."""
    ts, tcam, steps = _launches(motion, textured_quad_pair(variant, motion))
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
    assert any((out[2][:, 0] >= 0).any() for _, out in steps)
