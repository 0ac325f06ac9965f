"""Whole renders through the port's walk pool against the reference's, as
tests/test_torch_walk_render.py: the textured quad with the material
dispatch and a normal map (K6's textured dispatch variant), the Cornell
box with AOV (the guide buffers at rtol 1e-4, atol 1e-5, as the AOV
tests hold them; the capacity-2 stash is off), and pool_paths 2 and 3."""
import numpy as np
import pytest

from torch_port_util import cornell_pair, textured_quad_pair
from walk_render_util import assert_match, render_pair


def test_textured_dispatch():
    assert_match(*render_pair(*textured_quad_pair("principled")))


def test_aov_guide_buffers():
    got, want = render_pair(*cornell_pair(), aov=True, max_depth=3)
    assert_match(got, want)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    assert got[1][0].mean() > 0.1  # first-hit albedo present


@pytest.mark.parametrize("paths", [2, 3])
def test_pool_paths(paths):
    got, want = render_pair(*cornell_pair(), pool_paths=paths,
                            walk_phase_every=5)
    assert_match(got, want)
    assert got[4] == want[4]
