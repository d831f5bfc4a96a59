"""Seeded counter-based token sampling (mirrors
``deeplearning4j_tpu/ops/sampling.py``), bit-exact with the reference's
noise on the CPU.

The reference keys each draw ``fold_in(PRNGKey(seed), step)`` and adds
``jax.random.gumbel(key, (V,))`` to the filtered logits.  To give the
same tokens from the same logits, the port carries that schedule over
bit for bit: threefry2x32 in jax's partitionable mode (counts are the
flat element index split into hi/lo words), ``uniform`` as 23 random
mantissa bits over [tiny, 1), and the gumbel transform ``-log(-log u)``
with ``log`` computed as XLA's CPU backend computes it (a Cephes-style
polynomial, with one fused multiply-add that the backend emits) — a
correctly rounded log differs from it in the last bit of ~14% of
inputs.  All 32-bit integer arithmetic runs on int64 masked with
``0xFFFFFFFF``, since torch's uint32 support is thin.

``sample_tokens_device`` is the batch sampler with every argument a
tensor on the logits' device and no read back to the host, so the fused
multi-step decode (``DecodeProgram.step_multi``) can run inside a CUDA
graph; ``sample_tokens`` takes host lists and gives the same bits.
``uniform`` and ``gumbel_from_key`` draw from any key, for speculative
decoding's own streams; ``split``, ``randint`` and ``uniform`` over a
row are jax's, for the word2vec negative sampler.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x: Tensor, r: int) -> Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1: Tensor, x2: Tensor) -> Tuple[Tensor, Tensor]:
    """The Threefry-2x32 hash (20 rounds) on int64 carriers of uint32
    words; keys and counts broadcast."""
    # graftcheck: disable=GC101 (key words already on the device pass through uncopied; the captured callers hand it device keys)
    k1 = torch.as_tensor(k1, dtype=torch.int64, device=x1.device)
    # graftcheck: disable=GC101 (key words already on the device pass through uncopied; the captured callers hand it device keys)
    k2 = torch.as_tensor(k2, dtype=torch.int64, device=x1.device)
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for rnd in range(5):
        for r in _ROT[rnd % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(rnd + 1) % 3]) & _M32
        x2 = (x2 + ks[(rnd + 2) % 3] + rnd + 1) & _M32
    return x1, x2


def prng_key(seed: Tensor) -> Tuple[Tensor, Tensor]:
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2**64: (hi, lo) words."""
    seed = torch.as_tensor(seed, dtype=torch.int64)
    return (seed >> 32) & _M32, seed & _M32


def fold_in(key: Tuple[Tensor, Tensor], data: Tensor) -> Tuple[Tensor, Tensor]:
    """``jax.random.fold_in(key, data)``: hash the count pair (0, data)."""
    # graftcheck: disable=GC101 (counts already on the device pass through uncopied; the captured callers hand it device counters)
    data = torch.as_tensor(data, dtype=torch.int64, device=key[0].device) & _M32
    return threefry2x32(key[0], key[1], torch.zeros_like(data), data)


def random_bits(key: Tuple[Tensor, Tensor], n: int) -> Tensor:
    """32 random bits per element of a length-``n`` draw; ``key`` words
    may carry a leading batch axis [S, 1] for one draw per row."""
    lo = torch.arange(n, dtype=torch.int64, device=key[0].device)
    b1, b2 = threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
    return b1 ^ b2


def uniform_tiny_one(bits: Tensor) -> Tensor:
    """``jax.random.uniform(minval=tiny, maxval=1.0)`` in float32."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    scale = np.float32(1.0) - np.float32(_F32_TINY)   # == 1.0 in float32
    return torch.clamp(f * float(scale) + _F32_TINY, min=_F32_TINY)


def _fma(a: Tensor, b, c) -> Tensor:
    """float32 a*b+c with a single rounding (exact product in float64)."""
    return (a.double() * b + c).float()


_LOG_P = [float(np.float32(v)) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1)]
_LOG_Q1 = float(np.float32(-2.12194440e-4))
_LOG_Q2 = float(np.float32(0.693359375))
_SQRTHF = float(np.float32(0.707106781186547524))


def xla_cpu_log(x: Tensor) -> Tensor:
    """Natural log of positive finite float32 values, bit-exact with
    XLA's CPU ``log``."""
    t = torch.clamp(x.float(), min=_F32_TINY)
    bits = t.view(torch.int32).to(torch.int64)
    e = (((bits >> 23) - 0x7F).float() + 1.0)
    t = ((bits & 0x807FFFFF) | 0x3F000000).to(torch.int32).view(torch.float32)
    mask = t < _SQRTHF
    t1 = torch.where(mask, t, torch.zeros_like(t))
    t = t - 1.0
    e = e - mask.float()
    t = t + t1
    x2 = t * t
    x3 = x2 * t
    p = _LOG_P
    y = _fma(t, p[0], p[1])
    y1 = _fma(t, p[3], p[4])
    y2 = _fma(t, p[6], p[7])
    y = _fma(y, t.double(), p[2])
    y1 = _fma(y1, t.double(), p[5])
    y2 = _fma(y2, t.double(), p[8])
    y = _fma(y, x3.double(), y1.double())
    y = _fma(y, x3.double(), y2.double())
    y = _fma(y, x3.double(), (e * _LOG_Q1).double())
    t = t - x2 * 0.5
    t = t + y
    return t + e * _LOG_Q2


def uniform(key: Tuple[Tensor, Tensor], n: Optional[int] = None) -> Tensor:
    """``jax.random.uniform(key)`` over [0, 1) in float32, bitwise: one
    draw per key (``n`` None; the result takes the key words' shape), or
    ``jax.random.uniform(key, (n,))`` per key (shape ``[*key, n]``; a
    draw of any shape is this one of its element count, reshaped)."""
    bits = random_bits((key[0].reshape(-1, 1), key[1].reshape(-1, 1)), n or 1)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return f.reshape(key[0].shape) if n is None else f.reshape(*key[0].shape, n)


def split(key: Tuple[Tensor, Tensor], num: int = 2) -> List[Tuple[Tensor, Tensor]]:
    """``jax.random.split(key, num)`` in partitionable mode: key ``j``
    hashes the count pair (0, j).  Key words of any shape split
    elementwise."""
    k0, k1 = key[0].unsqueeze(-1), key[1].unsqueeze(-1)
    j = torch.arange(num, dtype=torch.int64, device=key[0].device)
    b1, b2 = threefry2x32(k0, k1, torch.zeros_like(j), j)
    return [(b1[..., i], b2[..., i]) for i in range(num)]


def randint(key: Tuple[Tensor, Tensor], n: int, minval: int, maxval: int) -> Tensor:
    """``jax.random.randint(key, (n,), minval, maxval)``'s int32 values (as
    int64), one row of ``n`` per key, shape ``[*key, n]``: two 32-bit draws
    from the key's split, reduced by jax's span-multiplier rule
    ``((hi % span) * m + lo % span) % span`` with ``m = (2**16 % span)**2
    % span`` and every product and sum wrapped to uint32, as jax computes
    it (so ``m`` is 0 for spans of 2**16 and more)."""
    k1, k2 = split(key)
    flat = lambda k: (k[0].reshape(-1, 1), k[1].reshape(-1, 1))
    hi, lo = random_bits(flat(k1), n), random_bits(flat(k2), n)
    span = max(int(maxval) - int(minval), 1)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _M32) % span       # uint32: 0 once span >= 2**16
    off = (((hi % span) * mult) & _M32) + lo % span
    off = (off & _M32) % span
    return (off + int(minval)).reshape(*key[0].shape, n)


def gumbel_from_key(key: Tuple[Tensor, Tensor], n: int) -> Tensor:
    """[S, n] float32 gumbel noise, row i drawn from key i — bitwise
    ``jax.random.gumbel(key, (n,))`` on the CPU."""
    key = (key[0].reshape(-1, 1), key[1].reshape(-1, 1))
    u = uniform_tiny_one(random_bits(key, n))
    return -xla_cpu_log(-xla_cpu_log(u))


def gumbel(seeds: Tensor, steps: Tensor, n: int) -> Tensor:
    """[S, n] float32 gumbel noise, row i keyed
    ``fold_in(PRNGKey(seeds[i]), steps[i])`` — bitwise equal to
    ``jax.random.gumbel(fold_in(PRNGKey(seed), step), (n,))`` on the CPU."""
    return gumbel_from_key(fold_in(prng_key(seeds), steps), n)


def filtered_logits(lgs: Tensor, temps: Tensor, top_ks: Tensor, top_ps: Tensor,
                    vocab_size: int) -> Tensor:
    """[S, V] logits scaled by each row's temperature, with -inf outside
    its top-k and top-p sets (top_k 0 and top_p >= 1 keep every token;
    the top token always stays) — the reference sampler's filter, which
    speculative decoding's warped distribution shares."""
    t = temps.float().reshape(-1, 1)
    k = top_ks.long().reshape(-1, 1)
    p = top_ps.float().reshape(-1, 1)
    scaled = lgs / torch.clamp(t, min=1e-6)
    srt = torch.sort(scaled, dim=-1, descending=True).values
    kk = torch.clamp(torch.where(k > 0, k, torch.full_like(k, vocab_size)),
                     1, vocab_size)
    thr_k = srt.gather(-1, kk - 1)
    probs = torch.softmax(srt, dim=-1)
    cum_excl = torch.cumsum(probs, dim=-1) - probs   # mass BEFORE each entry
    keep = cum_excl < torch.clamp(p, 1e-6, 1.0)      # top-1 always kept
    inf = torch.full_like(srt, float("inf"))
    thr_p = torch.where(keep, srt, inf).amin(dim=-1, keepdim=True)
    thr = torch.maximum(thr_k, thr_p)
    return torch.where(scaled >= thr, scaled, -inf)


def sample_tokens_device(lgs: Tensor, temps: Tensor, top_ks: Tensor, top_ps: Tensor,
                         seeds: Tensor, steps: Tensor,
                         vocab_size: int) -> Tuple[Tensor, Tensor]:
    """The batch sampler with no host sync: every argument a tensor [S]
    on ``lgs``'s device.  Each row gets its greedy and its sampled token
    and ``where`` picks one, so a CUDA graph can hold it.  Temperature
    <= 0 is greedy; top_k 0 and top_p >= 1 disable those filters.
    Returns (tokens int64 [S], finite bool [S])."""
    lgs = lgs.float()
    finite = torch.isfinite(lgs).all(dim=-1)
    greedy = torch.argmax(lgs, dim=-1)
    masked = filtered_logits(lgs, temps, top_ks, top_ps, vocab_size)
    g = gumbel(seeds.long().reshape(-1), steps.long().reshape(-1), lgs.shape[-1])
    sampled = torch.argmax(masked + g, dim=-1)
    return torch.where(temps.reshape(-1) <= 0.0, greedy, sampled), finite


def sample_tokens(lgs: Tensor, temps, top_ks, top_ps, seeds, steps,
                  vocab_size: int) -> Tuple[Tensor, Tensor]:
    """Sample one token per logits row ``lgs`` [S, V] — the reference's
    ``sample_token`` over a batch, with the sampling arguments as host
    sequences.  An all-greedy batch skips the sampled branch; otherwise
    it is ``sample_tokens_device``.  Returns (tokens int64 [S], finite
    bool [S]), ``finite`` being the poison flag."""
    dev = lgs.device
    t = torch.as_tensor(temps, dtype=torch.float32).reshape(-1)
    if not bool((t > 0).any()):
        lgs = lgs.float()
        return torch.argmax(lgs, dim=-1), torch.isfinite(lgs).all(dim=-1)
    as_dev = lambda xs, dtype: torch.as_tensor(xs, dtype=dtype).reshape(-1).to(dev)
    return sample_tokens_device(lgs, t.to(dev), as_dev(top_ks, torch.int64),
                                as_dev(top_ps, torch.float32),
                                as_dev(seeds, torch.int64), as_dev(steps, torch.int64),
                                vocab_size)


def sample_token(lg: Tensor, t: float, k: int, p: float, seed: int,
                 step: int, vocab_size: int) -> Tuple[int, bool]:
    """One logits row [V] → (token, finite)."""
    tok, fin = sample_tokens(lg.reshape(1, -1), [t], [k], [p], [seed], [step],
                             vocab_size)
    return int(tok[0]), bool(fin[0])
