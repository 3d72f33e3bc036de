"""Rounding into the cache's storage dtype: stochastic rounding of the
per-step update (Kernel 4 of the port) and the deterministic storage cast of
every other write into the cache.

Counterpart of ``cachedembedding_tpu/ops/rounding.py`` (TPU kernel
``_sr_kernel``, wrapper ``_stochastic_astype_pallas``, emulation
``_stochastic_astype_emulated``). The CUDA kernel is
``csrc/stochastic_round.cu``; its note says what bounds it on the H100.

    stochastic_astype(x, dt, seed)      f32 -> dt with E[out] == x

The rounding is the JAX emulation's arithmetic, given uniforms ``r``
(``sr_from_uniform``): clip x to +-finfo(dt).max, round to nearest, find the
two neighbours by the monotonic bit key, and take the upper one when
``r < (x - lo) / (hi - lo)``. The uniforms come from ``philox_uniform``:
Philox4x32-10 keyed by (seed, 0); flat element i takes word i % 4 of the
block at counter (i // 4, 0, 0, 0), as ``(word >> 8) * 2**-24``. The kernel
computes the same bits as the plain version for the same seed. JAX draws its
uniforms with threefry (CPU) or the TPU's generator, so the random bits are
not JAX's: the tests hand JAX's uniforms to ``sr_from_uniform``.

``astype_storage`` is ``jnp.astype`` bit for bit (NaN inputs stay NaN, in
whatever encoding): round to nearest even, and beyond the largest finite
value what ml_dtypes gives. torch's own cast to float8_e4m3fn saturates
values that round beyond +-448 (and +-inf) to +-448; JAX gives NaN, and so
does ``astype_storage``. For float8_e5m2, |x| >= 61,440 (the midpoint above
57,344, which ties to even onto inf) gives +-inf, as in JAX; torch's CPU
cast agrees there, and ``astype_storage`` sets those codes itself so that no
device's cast can saturate them. ``index_copy_storage_`` writes rows through
it; fp8 rows go through a ``torch.uint8`` view, because ``index_copy_`` on
fp8 tensors is missing on the CPU.

On a CPU tensor ``stochastic_astype`` runs the plain PyTorch version; on a
CUDA tensor it launches the kernel or raises. torch has no uint32
arithmetic, so Philox runs in int64 with 32-bit masks, as the canonical row
hash does (``ops/synth_rows.py``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from cachedembedding_tpu_torch.ops import _cuda

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)

# storage dtype -> (integer view, sign bit, mask)
_BITS = {
    torch.bfloat16: (torch.int16, 1 << 15, 0xFFFF),
    torch.float8_e4m3fn: (torch.uint8, 1 << 7, 0xFF),
    torch.float8_e5m2: (torch.uint8, 1 << 7, 0xFF),
}
_E4M3_NAN_ABOVE = 464.0  # |x| > 464 rounds past 448 (0x7E) onto NaN (0x7F)
_E5M2_INF_FROM = 61440.0  # |x| >= 61440 rounds past 57344 (0x7B) onto inf (0x7C)
_DTYPE_CODES = {torch.bfloat16: 0, torch.float8_e4m3fn: 1, torch.float8_e5m2: 2}


# ---------------------------------------------------------------------------
# Philox4x32-10
# ---------------------------------------------------------------------------

def _mulhilo(m: int, a: torch.Tensor):
    """(hi, lo) 32-bit halves of m * a, for a constant m < 2^32 and int64 a
    in [0, 2^32), without overflowing int64 (16-bit halves of a)."""
    p_lo = m * (a & 0xFFFF)
    t = m * (a >> 16) + (p_lo >> 16)
    return t >> 16, ((t & 0xFFFF) << 16) | (p_lo & 0xFFFF)


def philox4x32_10(ctr: Sequence[torch.Tensor], key: Sequence[int]):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors that hold
    uint32 values: four counter words, a two-word key. Returns four words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key[0] & _M32, key[1] & _M32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _M32
        k1 = (k1 + _PHILOX_W[1]) & _M32
    return c0, c1, c2, c3


def philox_uniform(seed: int, shape, device=None) -> torch.Tensor:
    """f32 uniforms in [0, 1) of ``shape``: element i is word i % 4 of
    Philox4x32-10 at counter (i // 4, 0, 0, 0) with key (seed, 0), as
    (word >> 8) * 2**-24 (exact in f32)."""
    n = math.prod(shape)
    j = torch.arange(-(-n // 4), dtype=torch.int64, device=device)
    zero = torch.zeros_like(j)
    words = philox4x32_10((j & _M32, j >> 32, zero, zero), (int(seed), 0))
    bits = torch.stack(words, dim=1).reshape(-1)[:n]
    return ((bits >> 8).to(torch.float32) * 2.0**-24).reshape(shape)


# ---------------------------------------------------------------------------
# bit keys of the storage dtypes
# ---------------------------------------------------------------------------

def _bits_of(a: torch.Tensor) -> torch.Tensor:
    """Storage-dtype tensor -> its bit patterns as int32 in [0, 2^bits)."""
    view, _, mask = _BITS[a.dtype]
    return a.view(view).to(torch.int32) & mask


def _from_bits(k: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """int32 bit patterns in [0, 2^bits) -> storage-dtype tensor."""
    view, _, _ = _BITS[dt]
    if view == torch.int16:
        k = k - ((k >> 15) & 1) * 65536  # two's complement of the 16-bit pattern
    return k.to(view).view(dt)


def _key_of(u: torch.Tensor, sign: int) -> torch.Tensor:
    """IEEE bit pattern -> monotonically ordered unsigned key."""
    return torch.where((u & sign) != 0, (2 * sign - 1) - u, u | sign)


def _key_inv(k: torch.Tensor, sign: int) -> torch.Tensor:
    return torch.where((k & sign) != 0, k ^ sign, (2 * sign - 1) - k)


def storage_steps(a: torch.Tensor, b: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Distance, in representables of ``dt``, between two arrays of values
    exactly representable in ``dt`` (as int32)."""
    _, sign, _ = _BITS[dt]
    return (_key_of(_bits_of(a.to(dt)), sign) - _key_of(_bits_of(b.to(dt)), sign)).abs()


# ---------------------------------------------------------------------------
# stochastic rounding
# ---------------------------------------------------------------------------

def sr_from_uniform(x: torch.Tensor, r: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """The plain core: ``_stochastic_astype_emulated``'s arithmetic with the
    uniforms ``r`` given (same shape as ``x``)."""
    _, sign, _ = _BITS[dt]
    fmax = float(torch.finfo(dt).max)
    x = x.float().clamp(-fmax, fmax)  # NaN passes, as in jnp.clip
    a = x.to(dt)                      # in range: round to nearest even
    af = a.float()
    key = _key_of(_bits_of(a), sign)
    # one step toward +inf / -inf in the target dtype
    upf = _from_bits(_key_inv((key + 1).clamp_max(2 * sign - 1), sign), dt).float()
    dnf = _from_bits(_key_inv((key - 1).clamp_min(0), sign), dt).float()
    below = af <= x
    lo = torch.where(below, af, dnf)
    hi = torch.where(below, upf, af)
    hi = hi.clamp_max(fmax)  # NaN-propagating, as jnp.minimum: e4m3fn's step above 448 is NaN
    lo = lo.clamp_min(-fmax)
    span = hi - lo
    pos = span > 0
    p = torch.where(pos, (x - lo) / torch.where(pos, span, torch.ones_like(span)), torch.zeros_like(span))
    return torch.where(r < p, hi, lo).to(dt)


def stochastic_astype_plain(x: torch.Tensor, dt: torch.dtype, seed: int) -> torch.Tensor:
    """Plain PyTorch version of Kernel 4: Philox uniforms, then the core."""
    return sr_from_uniform(x, philox_uniform(seed, tuple(x.shape), x.device), dt)


def stochastic_astype(
    x: torch.Tensor, dt: torch.dtype, seed: int, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Round f32 ``x`` to ``dt`` (bf16, float8_e4m3fn or float8_e5m2) with
    E[out] == x; f32 returns ``x``. ``seed`` is a uint32 (vary it per step).
    With ``out`` (``dt``, x's shape) the result is written there."""
    if out is not None and (out.dtype != dt or out.shape != x.shape or out.device != x.device):
        raise ValueError("stochastic_astype: out must have x's shape and device and dtype dt")
    if dt == torch.float32:
        return x if out is None else out.copy_(x)
    if dt not in _DTYPE_CODES:
        raise ValueError(f"stochastic_astype rounds to bf16, float8_e4m3fn or float8_e5m2, not {dt}")
    if x.dtype != torch.float32:
        raise ValueError(f"stochastic_astype takes float32 input, not {x.dtype}")
    seed = int(seed) & _M32
    if x.device.type == "cpu":
        res = stochastic_astype_plain(x, dt, seed)
        return res if out is None else out.copy_(res)
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError("stochastic_astype needs a contiguous CUDA (or CPU) tensor")
    if out is None:
        out = torch.empty(x.shape, dtype=dt, device=x.device)
    elif not out.is_contiguous():
        raise ValueError("stochastic_astype needs a contiguous out")
    launch = _cuda.kernel_entry("stochastic_round")
    rc = launch(x.data_ptr(), out.data_ptr(), x.numel(), seed, _DTYPE_CODES[dt], _cuda.stream_of(x))
    _cuda.check_launch("stochastic_round", rc)
    stochastic_astype.launches += 1
    return out


stochastic_astype.launches = 0


def stochastic_sgd_round_plain(cw: torch.Tensor, g32: torch.Tensor, slr: float, seed: int) -> torch.Tensor:
    """Plain version of the fused entry: ``cw - slr * g32`` in f32, then
    Kernel 4's plain version into ``cw``'s dtype (a new tensor)."""
    return stochastic_astype_plain(torch.sub(cw.float(), g32, alpha=slr), cw.dtype, seed)


def stochastic_sgd_round_(cw: torch.Tensor, g32: torch.Tensor, slr: float, seed: int) -> torch.Tensor:
    """``cw = stochastic_astype(cw - slr * g32, cw.dtype, seed)``, in place,
    for bf16, float8_e4m3fn or float8_e5m2 rows ``cw`` and an f32 ``g32`` of
    the same shape. On the card one launch of Kernel 4 forms ``cw - slr * g``
    in registers (as ``torch.sub(..., alpha=slr)`` does there: one fused
    multiply-add) and rounds it into ``cw``; no f32 copy of ``cw`` is made.
    Returns ``cw``."""
    if cw.dtype not in _DTYPE_CODES:
        raise ValueError(f"stochastic_sgd_round_ rounds into bf16, float8_e4m3fn or float8_e5m2 rows, not {cw.dtype}")
    if g32.dtype != torch.float32:
        raise ValueError(f"stochastic_sgd_round_ takes a float32 grad, not {g32.dtype}")
    if g32.shape != cw.shape or g32.device != cw.device:
        raise ValueError("stochastic_sgd_round_: the grad must have the rows' shape and device")
    if not (cw.is_contiguous() and g32.is_contiguous()):
        raise ValueError("stochastic_sgd_round_ needs contiguous rows and grad")
    seed = int(seed) & _M32
    if cw.device.type == "cpu":
        return cw.copy_(stochastic_sgd_round_plain(cw, g32, slr, seed))
    if cw.device.type != "cuda":
        raise ValueError("stochastic_sgd_round_ needs CUDA (or CPU) tensors")
    launch = _cuda.kernel_entry("stochastic_sgd_round")
    rc = launch(cw.data_ptr(), g32.data_ptr(), cw.numel(), float(slr), seed, _DTYPE_CODES[cw.dtype], _cuda.stream_of(cw))
    _cuda.check_launch("stochastic_sgd_round", rc)
    stochastic_sgd_round_.launches += 1
    return cw


stochastic_sgd_round_.launches = 0


# ---------------------------------------------------------------------------
# deterministic storage cast
# ---------------------------------------------------------------------------

def astype_storage(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``x.astype(dt)`` as JAX computes it, bit for bit for every input but
    NaN (which stays a NaN): round to nearest even; for float8_e4m3fn NaN
    (0x7F, signed) where x rounds past +-448 (|x| > 464, +-inf), for
    float8_e5m2 inf (0x7C, signed) where it rounds past +-57344."""
    y = x.to(dt)
    if dt == torch.float8_e4m3fn:
        over, code = x.float().abs() > _E4M3_NAN_ABOVE, 0x7F
    elif dt == torch.float8_e5m2:
        over, code = x.float().abs() >= _E5M2_INF_FROM, 0x7C
    else:
        return y
    signed = torch.where(torch.signbit(x), 0x80 | code, code).to(torch.int32)
    return _from_bits(torch.where(over, signed, _bits_of(y)), dt)


def index_select_f32(src: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``src[index]`` widened to f32 (exactly); 1-byte rows are selected
    through a uint8 view, as ``index_copy_storage_`` writes them."""
    if src.element_size() == 1:
        return src.view(torch.uint8).index_select(0, index).view(src.dtype).float()
    return src.index_select(0, index).float()


def index_copy_storage_(dst: torch.Tensor, index: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``dst[index] = astype_storage(values, dst.dtype)``, in place. 1-byte
    rows go through a uint8 view (the CPU has no fp8 ``index_copy_``)."""
    v = astype_storage(values, dst.dtype)
    if dst.element_size() == 1:
        dst.view(torch.uint8).index_copy_(0, index, v.view(torch.uint8))
    else:
        dst.index_copy_(0, index, v)
    return dst
