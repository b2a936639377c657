"""Batched hash functions over key tensors, bit-identical to
`redisson_tpu.ops.hashing`.

Key batches are `[N, W]` uint8 tensors, zero-padded beyond per-key `lengths`
([N] int32); 64-bit integer keys are int64 tensors holding the key's bits
(see `ops.u64`). All lanes are int64 (`ops.u64` handles the unsigned
semantics). Variable key length is branch-free, as in the JAX package: full
blocks run over ceil(W/block) unrolled steps with a per-key `i < nblocks`
select, and the tail is gathered at each key's block end, where zero padding
makes the canonical tail switch an unconditional mix.

The Bloom filter hashes with the two murmur3 x64 128 halves, as the JAX
package does. `xxhash64` (`redisson_tpu/ops/hashing.py`) is still to port;
ROADMAP.md lists it.
"""

from __future__ import annotations

import torch

from redisson_tpu_torch.ops import u64 as u

# MurmurHash3 x64 128 constants.
_C1 = 0x87C37B91114253D5
_C2 = 0x4CF5AD432745937F

# MurmurHash64A (Redis's HLL hash, hyperloglog.c hllPatLen).
REDIS_HLL_SEED = 0xADC83B19
_M64A = 0xC6A4A7935BD1E995


def _le64(b: torch.Tensor) -> torch.Tensor:
    """[..., 8] uint8 -> int64 little-endian."""
    b = b.to(torch.int64)
    out = b[..., 0]
    for i in range(1, 8):
        out = out | (b[..., i] << (8 * i))
    return out


def _masked_buffer(data: torch.Tensor, lengths: torch.Tensor, block: int):
    """Zero-pad to whole blocks plus one spare block (the tail gather at
    offset nblocks*block stays in bounds), zeroing bytes past each length."""
    n, w = data.shape
    wp = (w // block) * block + block
    buf = torch.zeros((n, wp), dtype=torch.uint8, device=data.device)
    buf[:, :w] = data
    pos = torch.arange(wp, dtype=torch.int32, device=data.device)[None, :]
    return buf.masked_fill_(pos >= lengths[:, None], 0)


def fmix64(k: torch.Tensor) -> torch.Tensor:
    k = k ^ u.shr(k, 33)
    k = u.mul(k, 0xFF51AFD7ED558CCD)
    k = k ^ u.shr(k, 33)
    k = u.mul(k, 0xC4CEB9FE1A85EC53)
    return k ^ u.shr(k, 33)


def _mm_mix_k1(k1: torch.Tensor) -> torch.Tensor:
    return u.mul(u.rotl(u.mul(k1, _C1), 31), _C2)


def _mm_mix_k2(k2: torch.Tensor) -> torch.Tensor:
    return u.mul(u.rotl(u.mul(k2, _C2), 33), _C1)


def _mm_body(h1, h2, k1, k2):
    h1 = u.rotl(h1 ^ _mm_mix_k1(k1), 27) + h2
    h1 = u.mul(h1, 5) + 0x52DCE729
    h2 = u.rotl(h2 ^ _mm_mix_k2(k2), 31) + h1
    h2 = u.mul(h2, 5) + 0x38495AB5
    return h1, h2


def _mm_final(h1, h2, lengths):
    ln = lengths.to(torch.int64)
    h1 = h1 ^ ln
    h2 = h2 ^ ln
    h1 = h1 + h2
    h2 = h2 + h1
    h1 = fmix64(h1)
    h2 = fmix64(h2)
    h1 = h1 + h2
    h2 = h2 + h1
    return h1, h2


def murmur3_x64_128(data: torch.Tensor, lengths: torch.Tensor, seed: int = 0):
    """Batched MurmurHash3 x64 128 of [N, W] uint8 keys -> (h1, h2) int64."""
    n, w = data.shape
    buf = _masked_buffer(data, lengths, 16)
    nblocks = lengths // 16
    h1 = u.full((n,), seed, data.device)
    h2 = u.full((n,), seed, data.device)
    for i in range(w // 16):
        block = buf[:, 16 * i: 16 * i + 16]
        h1n, h2n = _mm_body(h1, h2, _le64(block[:, 0:8]), _le64(block[:, 8:16]))
        active = i < nblocks
        h1 = torch.where(active, h1n, h1)
        h2 = torch.where(active, h2n, h2)
    tidx = (nblocks[:, None] * 16
            + torch.arange(16, dtype=torch.int32, device=data.device)[None, :])
    tail = torch.take_along_dim(buf, tidx.long(), dim=1)
    h2 = h2 ^ _mm_mix_k2(_le64(tail[:, 8:16]))
    h1 = h1 ^ _mm_mix_k1(_le64(tail[:, 0:8]))
    return _mm_final(h1, h2, lengths)


def murmur3_x64_128_u64(x: torch.Tensor, seed: int = 0):
    """MurmurHash3 x64 128 of each key's 8-byte little-endian encoding: the
    whole key is the tail, so this is a handful of lane ops."""
    h1 = u.full(x.shape, seed, x.device)
    h2 = u.full(x.shape, seed, x.device)
    h1 = h1 ^ _mm_mix_k1(x)
    lengths = torch.full(x.shape, 8, dtype=torch.int64, device=x.device)
    return _mm_final(h1, h2, lengths)


def _m64a_mix(k: torch.Tensor) -> torch.Tensor:
    k = u.mul(k, _M64A)
    k = k ^ u.shr(k, 47)
    return u.mul(k, _M64A)


def _m64a_final(h: torch.Tensor) -> torch.Tensor:
    h = h ^ u.shr(h, 47)
    h = u.mul(h, _M64A)
    return h ^ u.shr(h, 47)


def murmur2_64a(data: torch.Tensor, lengths: torch.Tensor,
                seed: int = REDIS_HLL_SEED) -> torch.Tensor:
    """Batched MurmurHash64A over [N, W] zero-padded uint8 keys, bit-exact
    with Redis's unaligned little-endian reads. The tail (< 8 trailing
    bytes) reads as a zero-padded word, with the trailing `h *= m` applied
    only where a tail exists."""
    n, w = data.shape
    buf = _masked_buffer(data, lengths, 8)
    nblocks = lengths // 8
    h = u.full((n,), seed, data.device) ^ u.mul(lengths.to(torch.int64), _M64A)
    for i in range(w // 8):
        hn = u.mul(h ^ _m64a_mix(_le64(buf[:, 8 * i: 8 * i + 8])), _M64A)
        h = torch.where(i < nblocks, hn, h)
    tidx = (nblocks[:, None] * 8
            + torch.arange(8, dtype=torch.int32, device=data.device)[None, :])
    tail = _le64(torch.take_along_dim(buf, tidx.long(), dim=1))
    hn = u.mul(h ^ tail, _M64A)
    h = torch.where((lengths % 8) != 0, hn, h)
    return _m64a_final(h)


def murmur2_64a_u64(x: torch.Tensor, seed: int = REDIS_HLL_SEED) -> torch.Tensor:
    """MurmurHash64A of each key's 8-byte LE encoding (one body block, no
    tail): the integer fast path of the redis-compatible HLL family."""
    h0 = (seed ^ (8 * _M64A)) & u.MASK64
    h = u.mul(u.full(x.shape, h0, x.device) ^ _m64a_mix(x), _M64A)
    return _m64a_final(h)
