# Frozen copy of artes_tpu_torch/transport/rng.py at commit bba47c3; only its imports
# are renamed. The benchmark's reference: it imports nothing of artes_tpu_torch.
"""Counter-based RNG for photon transport: threefry2x32 on torch tensors.

The stream is the one of ``artes_tpu.transport.rng``: every draw is a pure
function ``value(seed, photon_id, site)``, so the plain PyTorch transport,
the CUDA kernel (``csrc/pool_radial.cu``) and the JAX package produce the
same photon histories from the same (seed, id).

torch has no complete uint32 arithmetic, and ``>>`` on int32 is an
arithmetic shift. Words are therefore carried as int64 tensors holding
values in [0, 2^32): every add is masked back to 32 bits, and right shifts
of non-negative values are logical.

float32 draws use the mantissa trick on word ``site & 1`` of the hash of
counter ``site >> 1``; float64 draws combine both words of the hash of
counter ``site``. The two dtypes are distinct streams.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
PARITY = 0x1BD11BDA      # threefry key-schedule parity constant
GOLDEN = 0x9E3779B9      # Weyl constant folding the high id word into k0
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

F32_TINY = 1.1754943508222875e-38     # finfo(float32).tiny
F32_ONE_MINUS = 1.0 - 2.0 ** -24      # 1 - finfo(float32).epsneg
F64_TINY = 2.2250738585072014e-308
F64_ONE_MINUS = 1.0 - 2.0 ** -53


def key_hi(seed: int, id_hi: int = 0) -> int:
    """Effective k0 for photons whose 64-bit id has high word ``id_hi``."""
    return (int(seed) + int(id_hi) * GOLDEN) & MASK32


def photon_keys(seed: int, photon_ids: torch.Tensor, id_hi: int = 0) -> torch.Tensor:
    """(B, 2) int64 key pairs (k0, k1) for the low id words ``photon_ids``."""
    pid = photon_ids.to(torch.int64) & MASK32
    k0 = torch.full_like(pid, key_hi(seed, id_hi))
    return torch.stack([k0, pid], dim=-1)


def _rotl(x, r):
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0, k1, c0, c1):
    """The 20-round Threefry-2x32 block cipher on int64 words in [0, 2^32)."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (c0 + ks[0]) & MASK32
    x1 = (c1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def _bits_to_f32(bits):
    mant = (bits >> 9) | 0x3F800000
    u = mant.to(torch.int32).view(torch.float32) - 1.0
    # strictly (0, 1): the 1 - u inside every log stays positive
    return torch.clamp(u, F32_TINY, F32_ONE_MINUS)


def _words_to_f64(w0, w1):
    u = w0.to(torch.float64) * (2.0 ** -32) + w1.to(torch.float64) * (2.0 ** -64)
    return torch.clamp(u, F64_TINY, F64_ONE_MINUS)


def uniform_n_kk(k0, k1, base_site, n: int, dtype=torch.float32):
    """``n`` uniforms at sites ``base_site .. base_site + n - 1``.

    ``k0``/``k1``/``base_site`` are int64 tensors (or ints) broadcastable to
    one shape. Returns a list of ``n`` tensors of ``dtype``.
    """
    k0, k1, s = torch.broadcast_tensors(*(torch.as_tensor(v, dtype=torch.int64,
                                                          device=_device(k0, k1, base_site))
                                          for v in (k0, k1, base_site)))
    zero = torch.zeros_like(s)
    if dtype == torch.float64:
        return [_words_to_f64(*threefry2x32(k0, k1, (s + i) & MASK32, zero))
                for i in range(n)]
    if dtype != torch.float32:
        raise ValueError(f"uniform draws are float32 or float64, not {dtype}")
    # the draw at site s+i is word (s+i)&1 of the hash of counter (s+i)>>1;
    # those counters span (s>>1) + 0 .. (s>>1) + n//2 for either parity of s
    base_ctr = s >> 1
    ws = [threefry2x32(k0, k1, (base_ctr + j) & MASK32, zero)
          for j in range(n // 2 + 1)]
    odd = (s & 1) == 1
    out = []
    for i in range(n):
        off_even, off_odd = i >> 1, (i + 1) >> 1
        w0 = torch.where(odd, ws[off_odd][0], ws[off_even][0])
        w1 = torch.where(odd, ws[off_odd][1], ws[off_even][1])
        word = torch.where(((s + i) & 1) == 0, w0, w1)
        out.append(_bits_to_f32(word))
    return out


def uniform_n(keys, base_site, n: int, dtype=torch.float32):
    """:func:`uniform_n_kk` on stacked ``(..., 2)`` keys."""
    return uniform_n_kk(keys[..., 0], keys[..., 1], base_site, n, dtype)


def uniform(keys, site, dtype=torch.float32):
    """One uniform (0, 1) draw per photon at draw-site ``site``."""
    return uniform_n(keys, site, 1, dtype)[0]


def _device(*vals):
    for v in vals:
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")
