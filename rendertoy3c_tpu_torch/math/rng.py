"""Per-lane tea/LCG streams, bit-exact with the reference's generator.

Port of rendertoy3c_tpu/math/rng.py (cuda/random.h:31-77). torch on the
CPU has no uint32 `+`, `<<` or `>>`, so a uint32 state is carried as an
int64 tensor holding values in [0, 2^32) and masked after every step. The
CUDA kernels use uint32_t directly.

The pool stores a lane's state as the raw bits of a float32 column
(`misc[:, 0]`); `bits_to_state` / `state_to_bits` convert between the two.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
LCG_A = 1664525
LCG_C = 1013904223
_LCG_MASK = 0x00FFFFFF
_INV_2_24 = 1.0 / float(1 << 24)


def as_u32(x, device=None) -> torch.Tensor:
    """Any integer tensor (or int) -> int64 tensor of its uint32 value."""
    x = torch.as_tensor(x, device=device)
    return x.to(torch.int64) & M32


def mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2^32 for uint32 values held in int64, without overflow:
    the product is split at 16 bits of `a`."""
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & M32


def tea(val0, val1, rounds: int = 4) -> torch.Tensor:
    """TEA hash of two uint32s -> uint32 seed (cuda/random.h:31-46)."""
    v0 = as_u32(val0)
    v0, v1 = torch.broadcast_tensors(v0, as_u32(val1, device=v0.device))
    s0 = 0
    for _ in range(rounds):
        s0 = (s0 + 0x9E3779B9) & M32
        v0 = (v0 + ((((v1 << 4) + 0xA341316C) & M32)
                    ^ ((v1 + s0) & M32)
                    ^ (((v1 >> 5) + 0xC8013EA4) & M32))) & M32
        v1 = (v1 + ((((v0 << 4) + 0xAD90777D) & M32)
                    ^ ((v0 + s0) & M32)
                    ^ (((v0 >> 5) + 0x7E95761E) & M32))) & M32
    return v0


def lcg(state: torch.Tensor):
    """One LCG step; returns (new_state, 24-bit output) (cuda/random.h:49-55)."""
    new = (LCG_A * state + LCG_C) & M32
    return new, new & _LCG_MASK


def rnd(state: torch.Tensor):
    """Uniform float32 in [0, 1); returns (new_state, u) (cuda/random.h:64-67)."""
    new, bits = lcg(state)
    return new, bits.to(torch.float32) * _INV_2_24


def rnd_masked(state: torch.Tensor, mask: torch.Tensor):
    """Draw a uniform but advance only the lanes where mask is True."""
    new, u = rnd(state)
    return torch.where(mask, new, state), u


def sample_start(pixel, subframe_index: int, seed_rot: int, samp_idx,
                 jump: torch.Tensor):
    """(state, jx, jy): the stream of sample `samp_idx` of each pixel (both
    int64 [R]) after its two jitter draws (raygen.cu:32-39). The stream is
    tea(pixel, subframe) XOR seed_rot (`pixel_streams`), moved past the
    two draws of each earlier sample by row samp_idx of `jump` ([spp, 2]
    int64 (a, c) rows, integrate/path.py `_lcg_advance_table`); indices
    outside [1, spp) take row 0."""
    return sample_start_from(pixel_streams(pixel, subframe_index, seed_rot),
                             samp_idx, jump)


def pixel_streams(pixel, subframe_index: int, seed_rot: int):
    """tea(pixel, subframe) XOR seed_rot: each pixel's stream before its
    samples' jumps."""
    st = tea(pixel, subframe_index)
    if seed_rot:
        st = st ^ (seed_rot & M32)
    return st


def sample_start_from(st, samp_idx, jump: torch.Tensor):
    """sample_start from the pixels' streams `st` (pixel_streams)."""
    spp = jump.shape[0]
    aj = jump[torch.where((samp_idx >= 1) & (samp_idx < spp), samp_idx,
                          torch.zeros_like(samp_idx))]
    st = (mul32(aj[:, 0], st) + aj[:, 1]) & M32
    st, jx = rnd(st)
    st, jy = rnd(st)
    return st, jx, jy


def rot_seed(seed, frame) -> torch.Tensor:
    """cuda/random.h:74-77."""
    seed = as_u32(seed)
    return seed ^ as_u32(frame, device=seed.device)


def bits_to_state(col: torch.Tensor) -> torch.Tensor:
    """float32 column holding uint32 bits -> int64 state."""
    return col.contiguous().view(torch.int32).to(torch.int64) & M32


def state_to_bits(state: torch.Tensor) -> torch.Tensor:
    """int64 state in [0, 2^32) -> float32 tensor with the same bits."""
    signed = (state ^ 0x80000000) - 0x80000000
    return signed.to(torch.int32).view(torch.float32)
