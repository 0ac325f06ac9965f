"""Port RNG streams are bit-exact with rendertoy3c_tpu.math.rng over 1e5+
lanes (tolerance: none)."""
import jax.numpy as jnp
import numpy as np
import torch

from rendertoy3c_tpu.integrate.path import _lcg_advance_table as j_table
from rendertoy3c_tpu.math import rng as jrng
from rendertoy3c_tpu_torch.integrate.path import _lcg_advance_table
from rendertoy3c_tpu_torch.math import rng

N = 1 << 17


def _u32(seed, n=N):
    return np.random.default_rng(seed).integers(0, 1 << 32, n,
                                                dtype=np.uint64).astype(
                                                    np.uint32)


def _t(a):
    return torch.as_tensor(a.astype(np.int64))


def test_tea_bit_exact():
    v0, v1 = _u32(0), _u32(1)
    want = np.asarray(jrng.tea(jnp.asarray(v0), jnp.asarray(v1)))
    got = rng.tea(_t(v0), _t(v1)).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_tea_of_int32_pixel_and_scalar_frame():
    pix = np.arange(N, dtype=np.int32)
    want = np.asarray(jrng.tea(jnp.asarray(pix), jnp.uint32(5)))
    got = rng.tea(torch.arange(N, dtype=torch.int32), 5)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_lcg_and_rnd_streams_bit_exact():
    s_j = jnp.asarray(_u32(2))
    s_t = _t(_u32(2))
    for _ in range(6):
        n_j, bits_j = jrng.lcg(s_j)
        n_t, bits_t = rng.lcg(s_t)
        np.testing.assert_array_equal(n_t.numpy().astype(np.uint32),
                                      np.asarray(n_j))
        np.testing.assert_array_equal(bits_t.numpy().astype(np.uint32),
                                      np.asarray(bits_j))
        s_j, u_j = jrng.rnd(s_j)
        s_t, u_t = rng.rnd(s_t)
        np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_j))
        np.testing.assert_array_equal(s_t.numpy().astype(np.uint32),
                                      np.asarray(s_j))


def test_rnd_masked_bit_exact():
    mask = np.random.default_rng(3).random(N) < 0.5
    s_j, u_j = jrng.rnd_masked(jnp.asarray(_u32(4)), jnp.asarray(mask))
    s_t, u_t = rng.rnd_masked(_t(_u32(4)), torch.as_tensor(mask))
    np.testing.assert_array_equal(s_t.numpy().astype(np.uint32),
                                  np.asarray(s_j))
    np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_j))


def test_rot_seed_bit_exact():
    want = np.asarray(jrng.rot_seed(jnp.asarray(_u32(5)), 0x1234ABCD))
    got = rng.rot_seed(_t(_u32(5)), 0x1234ABCD)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_lcg_advance_table_and_jump():
    """The table equals the reference's, and a x s + c (via mul32) lands
    where 2 draws per earlier sample would."""
    for spp in (1, 2, 8, 16):
        np.testing.assert_array_equal(_lcg_advance_table(spp),
                                      np.asarray(j_table(spp)))
    table = torch.as_tensor(_lcg_advance_table(8).astype(np.int64))
    s0 = _t(_u32(6))
    s = s0.clone()
    for k in range(8):
        jumped = (rng.mul32(table[k, 0].expand(N), s0) + table[k, 1]) & rng.M32
        np.testing.assert_array_equal(jumped.numpy(), s.numpy())
        s, _ = rng.rnd(s)
        s, _ = rng.rnd(s)


def test_state_bits_round_trip():
    s = _t(_u32(7))
    bits = rng.state_to_bits(s)
    assert bits.dtype == torch.float32
    np.testing.assert_array_equal(bits.numpy().view(np.uint32),
                                  s.numpy().astype(np.uint32))
    np.testing.assert_array_equal(rng.bits_to_state(bits).numpy(), s.numpy())
