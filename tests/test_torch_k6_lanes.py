"""K6's lanes on the CPU. The kernel shades each lane alone, in 32-lane
blocks whose last one is short; its plain version `external_shade_ref`
must give a lane the same bits whatever lanes are shaded beside it: a
lone block, the short last block and a single lane against the whole
launch, in both misc layouts and every variant K6 takes, at lane counts
that are not a multiple of the block (1, 100, 8192 + 37). The kernel
itself is held to the plain version on the card (tests/test_torch_cuda.py).
Then the agreement rule of the K6 reference tests (tests/k6_agree_util.py)
on outputs that agree, and on outputs with one lane broken."""
import numpy as np
import pytest
import torch

from k6_agree_util import check_iteration
from k6_case_util import VARIANTS, k6_case
from rendertoy3c_tpu_torch.trace import shade

BLOCK = 32  # external.cu's EXT_LANES


def _bits(t):
    return t.contiguous().view(torch.int32)


def _lanes(x, lo, hi, c_major):
    return x[:, lo:hi] if c_major else x[lo:hi]


@pytest.mark.parametrize("n", [1, 100, 8192 + 37])
@pytest.mark.parametrize("layout", ["row_major", "c_major"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_lanes_shade_alone(variant, layout, n):
    rays, hit4, misc, tables, config, inst = k6_case(variant, n, seed=n)
    c_major = layout == "c_major"
    if c_major:
        misc = misc.T.contiguous()
    whole = shade.external_shade_ref(rays, hit4, misc, tables, config,
                                     transposed=c_major, inst=inst)
    last = (n - 1) // BLOCK * BLOCK
    for lo, hi in {(0, min(BLOCK, n)), (last, n), (n - 1, n)}:
        part = shade.external_shade_ref(
            rays[lo:hi], hit4[lo:hi], _lanes(misc, lo, hi, c_major).clone(),
            tables, config, transposed=c_major,
            inst=None if inst is None else inst[lo:hi])
        for g, w, what in zip(part, whole, ("rays", "misc", "shadow")):
            w = _lanes(w, lo, hi, c_major and what == "misc")
            assert g.shape == w.shape, what
            assert torch.equal(_bits(g), _bits(w)), (what, lo, hi)
    # the lanes are one bounce in: some live, some hit, some want a shadow
    m = misc.T if c_major else misc
    if n > 1:
        assert bool((m[:, 9] > 0).any()) and bool((hit4[:, 1] >= 0).any())
    if n > 100:
        col = whole[1][15] if c_major else whole[1][:, 15]
        assert bool((col > 0).any()) and bool((m[:, 8] > 0).any())


def _rule_case(variant):
    """One iteration's inputs and the plain version's outputs as numpy
    (C-major misc), and its tables and config."""
    rays, hit4, misc, tables, config, inst = k6_case(variant, 512, seed=3)
    misc = misc.T.contiguous()
    out = shade.external_shade_ref(rays, hit4, misc, tables, config,
                                   transposed=True, inst=inst)
    return ([x.numpy() for x in (rays, hit4, misc)],
            [x.numpy() for x in out], tables, config,
            None if inst is None else inst.numpy())


@pytest.mark.parametrize("broken", [None, "pixel", "seed_bit", "bounce",
                                    "nee_term", "want_shadow"])
def test_agree_rule_holds_and_rejects(broken):
    """The rule passes outputs that agree and fails when one live,
    well-conditioned lane differs: an integer column by one, the seed by
    its lowest bit, the bounce ray's origin or the NEE term by 1%, or
    want_shadow flipped."""
    (rays, hit4, misc), out, tables, config, inst = _rule_case("untextured")
    want = [x.copy() for x in out]
    res = check_iteration(rays, hit4, misc, out, want, tables, config, True,
                          inst=inst)
    assert res["worst"][0] == 0.0 and res["loose"] <= 0.4
    if broken is None:
        return
    mw = misc.shape[0]
    lit = (out[1][15] > 0) & (misc[9] > 0)
    lane = int(np.where(lit & (np.abs(out[1][mw]) > 1e-3))[0][0])
    got = [x.copy() for x in out]
    if broken == "pixel":
        got[1][13, lane] += 1.0
    elif broken == "seed_bit":
        got[1][0].view(np.uint32)[lane] ^= 1
    elif broken == "bounce":
        got[0][lane, 0] *= 1.01
    elif broken == "nee_term":
        got[1][mw, lane] *= 1.01
    else:
        got[1][15, lane] = 0.0
    with pytest.raises(AssertionError):
        check_iteration(rays, hit4, misc, got, want, tables, config, True,
                        inst=inst)
