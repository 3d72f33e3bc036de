"""Kernel 4's plain version and the storage cast (the port's ops/rounding.py)
against the JAX package's ops/rounding.py and ``jnp.astype``.

JAX draws its uniforms with threefry; the port with Philox4x32-10. So the
plain core ``sr_from_uniform`` is held bit for bit against
``_stochastic_astype_emulated`` with JAX's own uniforms handed to it, and the
port's ``stochastic_astype`` (with its own Philox) is held to the properties
``tests/test_rounding.py`` checks. On CPU tensors the wrapper runs the plain
version, which is what these tests exercise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cachedembedding_tpu.ops.rounding import _stochastic_astype_emulated
from cachedembedding_tpu_torch.ops import rounding
from cachedembedding_tpu_torch.ops.rounding import (
    astype_storage,
    index_copy_storage_,
    philox4x32_10,
    philox_uniform,
    sr_from_uniform,
    stochastic_astype,
    stochastic_sgd_round_,
    stochastic_sgd_round_plain,
)

_DT = {
    "bfloat16": (jnp.bfloat16, torch.bfloat16, np.uint16, torch.int16),
    "float8_e4m3fn": (jnp.float8_e4m3fn, torch.float8_e4m3fn, np.uint8, torch.uint8),
    "float8_e5m2": (jnp.float8_e5m2, torch.float8_e5m2, np.uint8, torch.uint8),
}


def _jax_uniform(seed, shape):
    return np.array(jax.random.uniform(jax.random.PRNGKey(jnp.uint32(seed)), shape, jnp.float32))


def _bits(t: torch.Tensor, name: str) -> np.ndarray:
    _, _, np_u, view = _DT[name]
    return t.view(view).numpy().astype(np.int64) & (0xFFFF if np_u == np.uint16 else 0xFF)


def test_philox_known_answers():
    """Random123's known-answer vectors for Philox4x32-10."""
    cases = [
        ([0, 0, 0, 0], [0, 0], [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]),
        ([0xFFFFFFFF] * 4, [0xFFFFFFFF] * 2, [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]),
        ([0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344], [0xA4093822, 0x299F31D0],
         [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]),
    ]
    for ctr, key, want in cases:
        got = philox4x32_10([torch.tensor([c], dtype=torch.int64) for c in ctr], key)
        assert [int(w) for w in got] == want


def test_philox_uniform_layout():
    """Element i is word i % 4 of the block at counter i // 4, as
    (word >> 8) * 2^-24: in [0, 1), exact in f32, ragged tails included."""
    u = philox_uniform(123, (3, 7))
    j = torch.arange(6, dtype=torch.int64)
    words = philox4x32_10((j, torch.zeros_like(j), torch.zeros_like(j), torch.zeros_like(j)), (123, 0))
    want = (torch.stack(words, 1).reshape(-1)[:21] >> 8).double() * 2.0**-24
    assert u.dtype == torch.float32 and u.shape == (3, 7)
    np.testing.assert_array_equal(u.reshape(-1).double().numpy(), want.numpy())
    big = philox_uniform(0, (1 << 16,))
    assert 0.0 <= float(big.min()) and float(big.max()) < 1.0
    assert abs(float(big.mean()) - 0.5) < 0.01
    assert not torch.equal(philox_uniform(1, (64,)), philox_uniform(2, (64,)))


def _core_cases(name: str, rng) -> np.ndarray:
    jdt = _DT[name][0]
    fi = jnp.finfo(jdt)
    fmax, tiny = float(fi.max), float(fi.tiny)
    normal = rng.standard_normal(3000) * 3
    near_max = np.concatenate([
        [fmax, -fmax, fmax * 1.01, -fmax * 1.5, fmax * 4, -fmax * 4],
        fmax * rng.uniform(0.9, 1.1, 200) * rng.choice([-1, 1], 200),
    ])
    exact = np.array([0.0, -0.0, 1.0, 0.5, -2.0, 0.125, -448.0 if fmax >= 448 else -1.0])
    parts = [normal, near_max, exact]
    if name != "bfloat16":
        # fp8 subnormals are normal f32 values. bf16's are f32 subnormals,
        # which XLA's CPU backend flushes to zero (torch and CUDA keep them),
        # so they cannot be compared bit for bit against the JAX emulation.
        parts.append(rng.uniform(-2, 2, 500) * tiny)
    return np.concatenate(parts).astype(np.float32)


@pytest.mark.parametrize("name", list(_DT))
@pytest.mark.parametrize("seed", [0, 7, 2**32 - 1])
def test_core_matches_jax_emulation_bit_for_bit(name, seed):
    rng = np.random.default_rng(seed % 1000)
    x = _core_cases(name, rng)
    jdt, tdt, np_u, _ = _DT[name]
    ref = np.asarray(_stochastic_astype_emulated(jnp.asarray(x), jnp.uint32(seed), jdt)).view(np_u)
    r = _jax_uniform(seed, x.shape)
    got = _bits(sr_from_uniform(torch.from_numpy(x), torch.from_numpy(r), tdt), name)
    np.testing.assert_array_equal(got, ref.astype(np.int64))


@pytest.mark.parametrize("name,ulp_rel,ulp_abs", [
    ("bfloat16", 2.0 ** -7, 1e-5),
    ("float8_e4m3fn", 2.0 ** -2, 2.0 ** -9),  # abs floor: subnormal step
])
def test_rounds_to_adjacent_representables(name, ulp_rel, ulp_abs):
    tdt = _DT[name][1]
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal((64, 128)) * 3).astype(np.float32))
    out = stochastic_astype(x, tdt, 7)
    assert out.dtype == tdt
    out = out.float()
    assert torch.equal(out.to(tdt).float(), out)  # representable in the target dtype
    bound = ulp_rel * torch.maximum(x.abs(), out.abs()) + ulp_abs + 1e-7
    assert bool(((out - x).abs() <= bound).all())


@pytest.mark.parametrize("name", ["bfloat16", "float8_e4m3fn"])
def test_unbiased(name):
    """The mean over 200 seeds converges to x."""
    tdt = _DT[name][1]
    x = torch.full((4, 128), 1.0 + 1.0 / 32.0)  # between fp8 representables
    acc = torch.zeros((4, 128), dtype=torch.float64)
    n = 200
    for s in range(n):
        acc += stochastic_astype(x, tdt, s).double()
    mean = acc / n
    # per element: within 5 sigma of a Bernoulli mean over n draws
    np.testing.assert_allclose(mean.numpy(), x.double().numpy(), rtol=0, atol=0.025)
    # the global mean over 512 elements x n draws
    assert abs(float(mean.mean()) - float(x[0, 0])) <= 0.002


def test_exact_values_stay_exact():
    x = torch.tensor([[1.0, 0.5, -2.0, 0.0] * 32])
    for s in range(5):
        assert torch.equal(stochastic_astype(x, torch.float8_e4m3fn, s).float(), x)


def test_fp8_small_update_accumulates():
    """Repeated sub-ulp updates vanish under round-to-nearest and accumulate
    in expectation under stochastic rounding."""
    fp8 = torch.float8_e4m3fn
    w = torch.ones((8, 128))  # the fp8 ulp at 1.0 is 0.125
    delta, steps = 0.01, 100
    w_det = w.to(fp8)
    for _ in range(steps):
        w_det = (w_det.float() + delta).to(fp8)
    w_sto = w.to(fp8)
    for s in range(steps):
        w_sto = stochastic_astype(w_sto.float() + delta, fp8, s)
    assert float(w_det.float().mean()) - 1.0 == 0.0, "round-to-nearest should stagnate"
    assert float(w_sto.float().mean()) - 1.0 > 0.5  # expected drift steps * delta = 1.0


def test_stochastic_astype_out_and_f32():
    x = torch.randn(10, 16)
    assert stochastic_astype(x, torch.float32, 3) is x
    out = torch.empty((10, 16), dtype=torch.float8_e4m3fn)
    got = stochastic_astype(x, torch.float8_e4m3fn, 3, out=out)
    assert got is out
    np.testing.assert_array_equal(
        _bits(out, "float8_e4m3fn"), _bits(stochastic_astype(x, torch.float8_e4m3fn, 3), "float8_e4m3fn"))
    with pytest.raises(ValueError, match="out"):
        stochastic_astype(x, torch.float8_e4m3fn, 3, out=torch.empty((10, 16), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="float32 input"):
        stochastic_astype(x.bfloat16(), torch.float8_e4m3fn, 3)


def test_plain_version_draws_from_philox_uniform(monkeypatch):
    """The wrapper's plain path takes its uniforms from ``philox_uniform``,
    which the trainer tests replace with JAX's."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((16, 8)).astype(np.float32))
    monkeypatch.setattr(rounding, "philox_uniform", lambda seed, shape, device=None: torch.zeros(shape))
    # r = 0 < p takes the upper neighbour wherever x is not representable
    up = stochastic_astype(x, torch.float8_e4m3fn, 5).float()
    assert bool((up >= x).all())


_CAST_VALUES = np.array(
    [0.0, -0.0, 1e-9, 0.001, 0.3, -2.75, 300.0, 447.0, 448.0, 449.0, 460.0, 463.9, 464.0, 464.1,
     -464.0, -465.0, 470.0, 480.0, 500.0, 1e6, -1e6, 6e4, 57344.0, 61439.0, 61440.0, 65504.0, 1e30,
     3.3e38, np.inf, -np.inf, np.nan],
    np.float32,
)


@pytest.mark.parametrize("name", ["float32", *_DT])
@pytest.mark.parametrize("src", ["float32", "bfloat16"])
def test_astype_storage_matches_jnp(name, src):
    """Bit for bit with jnp.astype, including NaN where e4m3fn overflows
    (torch's own cast gives +-448 there). A NaN input stays NaN; its encoding
    is not compared (ml_dtypes' depends on the source dtype)."""
    xj = jnp.asarray(_CAST_VALUES).astype(jnp.bfloat16 if src == "bfloat16" else jnp.float32)
    raw = np.asarray(xj)
    xt = torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16) if src == "bfloat16" else torch.from_numpy(raw)
    nan = np.isnan(_CAST_VALUES)
    if name == "float32":
        got, want = astype_storage(xt, torch.float32).numpy(), np.asarray(xj.astype(jnp.float32))
        np.testing.assert_array_equal(got[~nan].view(np.uint32), want[~nan].view(np.uint32))
        assert np.isnan(got[nan]).all()
        return
    jdt, tdt, np_u, _ = _DT[name]
    out = astype_storage(xt, tdt)
    want = np.asarray(xj.astype(jdt)).view(np_u).astype(np.int64)
    np.testing.assert_array_equal(_bits(out, name)[~nan], want[~nan])
    assert torch.isnan(out.float()[torch.from_numpy(nan)]).all()


def test_torch_cast_saturates_where_jax_gives_nan():
    """The difference astype_storage exists for."""
    x = torch.tensor([460.0, 500.0, 1e6, -1e6])
    assert torch.equal(x.to(torch.float8_e4m3fn).float(), torch.tensor([448.0, 448.0, 448.0, -448.0]))
    got = astype_storage(x, torch.float8_e4m3fn).float()
    assert got[0] == 448.0 and bool(torch.isnan(got[1:]).all())


@pytest.mark.parametrize("name", ["float32", "bfloat16", "float8_e4m3fn"])
def test_index_copy_storage_rows(name):
    """Rows land through the storage cast; fp8 rows go through a uint8 view
    (torch's CPU index_copy_ has no fp8 kernel)."""
    tdt = {"float32": torch.float32, **{k: v[1] for k, v in _DT.items()}}[name]
    dst = torch.zeros((6, 4), dtype=tdt)
    vals = torch.tensor([[0.3, -1.0, 500.0, 2.0], [7.0, 0.0, -0.01, 1e-3]])
    index_copy_storage_(dst, torch.tensor([4, 1]), vals)
    want = astype_storage(vals, tdt).float()
    got = dst.float()
    np.testing.assert_array_equal(got[[4, 1]].numpy(), want.numpy())
    assert bool((got[[0, 2, 3, 5]] == 0).all())


# ---------------------------------------------------------------------------
# Kernel 4's integer rounding (csrc/stochastic_round.cu), modelled in numpy
# ---------------------------------------------------------------------------

# storage dtype -> (mantissa bits, biased f32 exponent of the smallest normal, f32 bits of max)
_KERNEL_PARAMS = {
    "float8_e4m3fn": (3, 121, 0x43E00000),
    "float8_e5m2": (2, 113, 0x47600000),
    "bfloat16": (7, 1, 0x7F7F0000),
}


def _kernel_carry_input(b: np.ndarray, name: str):
    """What the kernel computes before it looks at the uniform, step for
    step: per f32 bit pattern, the code's exponent part, w = n * 2^24 + D
    (n whole grid steps of the clipped |x|, D the dropped part in 2^-24
    steps: ceil(D) for x > 0, rne(D) for x < 0), the sign mask and NaN."""
    m_bits, emin, max_bits = _KERNEL_PARAMS[name]
    b = b.astype(np.int64)
    s = np.where(b >> 31 == 1, 0xFFFFFFFF, 0)
    ax = b & 0x7FFFFFFF
    a = np.minimum(ax, max_bits)
    e = np.maximum(a >> 23, 1)
    m = a - ((e - 1) << 23)
    lo = np.minimum(e, emin)
    sh = lo - (emin - m_bits - 1)
    v = m << np.maximum(sh, 0)
    r = np.minimum(np.maximum(-sh, 0), 25)
    mask = (1 << r) - 1
    add = (s & ((mask + ((v >> r) & 1)) >> 1)) | (~s & mask & 0xFFFFFFFF)
    return (e - lo) << m_bits, (v + add) >> r, s, ax > 0x7F800000


def _kernel_model(b: np.ndarray, k: np.ndarray, name: str) -> np.ndarray:
    """The kernel's output codes for f32 bit patterns ``b`` and 24-bit
    uniform integers ``k`` (u = k * 2^-24). NaN: e4m3fn +NaN -> 0x7E (448),
    -NaN -> 0xFF; e5m2 0x7F | sign; bf16 replays the platform's casts, so
    only NaN-ness is modelled."""
    if name == "bfloat16":  # 16 dropped bits everywhere, f32 subnormals included
        b = b.astype(np.int64)
        s = np.where(b >> 31 == 1, 0xFFFFFFFF, 0)
        a = np.minimum(b & 0x7FFFFFFF, 0x7F7F0000)
        kk = k ^ (~s & 0xFFFFFF)
        return ((a >> 16) + ((kk + ((a & 0xFFFF) << 8)) >> 24)) | (s & 0x8000)
    c0, w, s, nan = _kernel_carry_input(b, name)
    kk = k ^ (~s & 0xFFFFFF)
    out = (c0 + ((kk + w) >> 24)) | (s & 0x80)
    if name == "float8_e4m3fn":
        return np.where(nan, np.where(s != 0, 0xFF, 0x7E), out)
    return np.where(nan, 0x7F | (s & 0x80), out)


def _f32_patterns(rng) -> np.ndarray:
    """Every f32 exponent with sampled and edge mantissas, both signs: ±0,
    f32 subnormals, target subnormals, values beyond ±max, ±inf and NaNs."""
    mant = np.concatenate([
        rng.integers(0, 1 << 23, 24),
        [0, 1, 2, 0x7FFFFF, 0x400000, 0x400001, 0x3FFFFF, 0x80000, 0x80001, 0x7FFFF, 0x100000, 0x100001,
         0xFFFFF, 0x200000, 0x1FFFFF, 0x200001],
    ]).astype(np.int64)
    b = (np.arange(256, dtype=np.int64)[:, None] << 23 | mant[None, :]).reshape(-1)
    return np.concatenate([b, b | (1 << 31)])


@pytest.mark.parametrize("name", list(_DT))
@pytest.mark.parametrize("seed", [0, 7, 2**32 - 1])
def test_kernel_integer_rounding_model_matches_plain_core(name, seed):
    """The kernel's integer arithmetic (no conversions, no division), as the
    .cu computes it, equals ``sr_from_uniform`` bit for bit over every f32
    exponent, both signs, the special classes and target subnormals, with
    the seed's Philox uniforms and with the uniform set at each element's
    threshold and one grid step to either side (where the ceil / round to
    nearest even of a dropped fraction decides)."""
    rng = np.random.default_rng(seed % 1000)
    b = _f32_patterns(rng)
    _, tdt, _, _ = _DT[name]
    if name == "bfloat16":
        s = np.where(b >> 31 == 1, 0xFFFFFFFF, 0)
        w, nan = (np.minimum(b & 0x7FFFFFFF, 0x7F7F0000) & 0xFFFF) << 8, (b & 0x7FFFFFFF) > 0x7F800000
    else:
        _, w, s, nan = _kernel_carry_input(b, name)
    d = w & 0xFFFFFF
    t = np.where(s != 0, (1 << 24) - d, d)  # up iff k >= t (x < 0), k < t (x > 0)
    philox_k = (philox_uniform(seed, (b.size,)).double().numpy() * 2.0**24).astype(np.int64)
    x = torch.from_numpy(b.astype(np.uint32).view(np.float32).copy())
    for k in (philox_k, *(np.clip(t + s, 0, (1 << 24) - 1) for s in (-1, 0, 1))):
        r = torch.from_numpy((k * 2.0**-24).astype(np.float32))
        got = _kernel_model(b, k, name)
        ref = sr_from_uniform(x, r, tdt)
        want = _bits(ref, name)
        if name == "bfloat16":
            np.testing.assert_array_equal(got[~nan], want[~nan])
            assert torch.isnan(ref.float()[torch.from_numpy(nan)]).all()
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["float8_e4m3fn", "float8_e5m2"])
def test_nan_rounds_as_jax_emulation(name):
    """A quirk the kernel keeps: for float8_e4m3fn the emulation rounds +NaN
    to 448 (``below`` is false, so ``lo`` is the step under the NaN code
    0x7F) and keeps -NaN a NaN; e5m2 keeps both NaNs."""
    jdt, tdt, np_u, _ = _DT[name]
    x = np.array([np.nan, -np.nan, 1.0], np.float32)
    ref = np.asarray(_stochastic_astype_emulated(jnp.asarray(x), jnp.uint32(3), jdt))
    got = sr_from_uniform(torch.from_numpy(x), torch.from_numpy(_jax_uniform(3, x.shape)), tdt)
    want = _kernel_model(x.view(np.uint32).astype(np.int64), np.zeros(3, np.int64), name)
    if name == "float8_e4m3fn":
        assert ref[0] == 448.0 and np.isnan(ref[1].astype(np.float32))
        assert got.float()[0] == 448.0 and torch.isnan(got.float()[1])
    else:
        assert np.isnan(ref[:2].astype(np.float32)).all() and torch.isnan(got.float()[:2]).all()
    np.testing.assert_array_equal(_bits(got, name), want)


@pytest.mark.parametrize("name", list(_DT))
def test_fused_sgd_round_equals_unfused_chain(name):
    """``stochastic_sgd_round_`` on CPU tensors: in place, bit-equal to
    ``cw.float() - slr * g`` rounded by the plain version, for each storage
    dtype and two learning rates."""
    _, tdt, _, _ = _DT[name]
    rng = np.random.default_rng(4)
    cw0 = stochastic_astype(torch.from_numpy(rng.standard_normal((48, 20)).astype(np.float32)), tdt, 1)
    g = torch.from_numpy((rng.standard_normal((48, 20)) * 0.05).astype(np.float32))
    for slr in (1.0, 0.37):
        cw = cw0.clone()
        assert stochastic_sgd_round_(cw, g, slr, 11) is cw
        want = stochastic_astype(torch.sub(cw0.float(), g, alpha=slr), tdt, 11)
        np.testing.assert_array_equal(_bits(cw, name), _bits(want, name))
        np.testing.assert_array_equal(_bits(stochastic_sgd_round_plain(cw0, g, slr, 11), name), _bits(want, name))


def test_fused_sgd_round_rejects_bad_inputs():
    cw = torch.zeros((8, 16)).to(torch.float8_e4m3fn)
    g = torch.zeros((8, 16))
    with pytest.raises(ValueError, match="rows"):
        stochastic_sgd_round_(torch.zeros((8, 16)), g, 1.0, 0)  # f32 rows take cw.sub_
    with pytest.raises(ValueError, match="float32 grad"):
        stochastic_sgd_round_(cw, g.bfloat16(), 1.0, 0)
    with pytest.raises(ValueError, match="shape"):
        stochastic_sgd_round_(cw, torch.zeros((8, 8)), 1.0, 0)
    with pytest.raises(ValueError, match="contiguous"):
        stochastic_sgd_round_(cw, torch.zeros((16, 8)).t(), 1.0, 0)
    with pytest.raises(ValueError, match="contiguous"):
        stochastic_sgd_round_(torch.zeros((16, 8)).to(torch.float8_e4m3fn).t(), g, 1.0, 0)
