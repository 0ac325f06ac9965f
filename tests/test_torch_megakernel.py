"""K4's plain version (trace_shade_refill_ref) against the reference refill
megakernel in interpret mode, teacher-forced: both get the same state at
every launch (the reference's output of the launch before).

Cornell 16x16, 2 spp, depth 4, pool 512, 8 launches. Stats exact; the
integer-valued columns exact and the float columns within rtol = atol =
3e-5 on at least 98% of lanes (last-ulp differences of sqrt/cos between
XLA and torch may flip one lane's Russian roulette)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendertoy3c_tpu.integrate.config import RenderConfig as JConfig
from rendertoy3c_tpu.trace.pallas_shade import make_fused_shader
from rendertoy3c_tpu.trace.pallas_mt import build_tri_soup as j_soup
from rendertoy3c_tpu_torch.integrate.config import RenderConfig
from rendertoy3c_tpu_torch.trace import shade
from torch_port_util import cornell_pair

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


@pytest.fixture(scope="module")
def reference_launches():
    """8 teacher-forcing steps of the reference: [(inputs, outputs)]."""
    js, ts, jcam, tcam = cornell_pair()
    soup = j_soup(js.geom, num_faces=js.num_faces)._replace(
        num_faces=js.num_faces)
    kern = make_fused_shader(js, JConfig(**CFG), soup, interpret=True,
                             merged=True,
                             refill=dict(n_pix=N_PIX, use_stash=True))
    rays, misc, stash = _initial_state(POOL)
    next_work, count = 0, 0
    steps = []
    for _ in range(8):
        sci = np.array([next_work, 0, SUB, 0], np.int32)
        r2, m2, s2, stats = kern(jnp.asarray(rays), jnp.asarray(misc),
                                 jnp.asarray(stash), count, sci,
                                 _scf(jcam))
        out = tuple(np.asarray(x) for x in (r2, m2, s2, stats))
        steps.append(((rays, misc, stash, next_work, count), out))
        rays, misc, stash = out[0].copy(), out[1].copy(), out[2].copy()
        next_work, count = int(out[3][0]), int(out[3][1])
    return ts, tcam, steps


def _run_port(ts, tcam, inputs, device, fn):
    rays, misc, stash, next_work, count = inputs
    pipe = shade.FusedPipeline(ts, RenderConfig(**CFG), device, refill_fn=fn)
    shader = pipe.refill_shader(N_PIX, use_stash=True)
    t = [torch.as_tensor(a.copy(), device=device) for a in (rays, misc, stash)]
    stats_in = torch.tensor([next_work, count, 0, 0], dtype=torch.int32,
                            device=device)
    stats_out = torch.zeros(4, dtype=torch.int32, device=device)
    shader(*t, stats_in, stats_out, 0, SUB, tuple(map(float, _scf(tcam))))
    return [x.cpu().numpy() for x in t] + [stats_out.cpu().numpy()]


@pytest.mark.parametrize("step", range(8))
def test_refill_ref_matches_reference_kernel(reference_launches, step):
    ts, tcam, steps = reference_launches
    inputs, want = steps[step]
    got = _run_port(ts, tcam, inputs, "cpu", shade.trace_shade_refill)
    np.testing.assert_array_equal(got[3], want[3])  # stats
    assert _lane_match(got[1], want[1], INT_COLS, exact=True) >= 0.98
    assert _lane_match(got[1], want[1], FLOAT_COLS, exact=False) >= 0.98
    assert _lane_match(got[0], want[0], list(range(8)), exact=False) >= 0.98
    assert _lane_match(got[2], want[2], list(range(16)), exact=False) >= 0.98


def test_teacher_forcing_covers_the_refill_epilogue(reference_launches):
    """The 8 steps see claims, finished samples and stash retirement."""
    _, _, steps = reference_launches
    stats = np.array([out[3] for _, out in steps])
    assert stats[0, 0] == N_PIX  # 512 idle lanes, claims clamped at 256
    assert (stats[:, 2] > 0).all()
    assert any((out[2][:, 0] >= 0).any() for _, out in steps)
