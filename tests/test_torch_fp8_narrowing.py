"""The fp8 narrowing of the port's CUDA kernels (``csrc/row_runs.cuh``,
``CvtFp8``), modelled in numpy and held against the JAX package's cast.

The kernels narrow an f32 value to float8_e4m3fn or float8_e5m2 in two
branches: where |x| is at most the largest finite value (448, 57,344) the
card's conversion ``cvt.rn.satfinite`` (round to nearest even; saturation
never applies there), and beyond it (|x| larger, +-inf, NaN) the emulated
no-saturation cast, which gives e4m3fn NaN (0x7F, signed) past 464 and
e5m2 inf (0x7C, signed) from 61,440. ``narrow_model`` computes both
branches from the values' bits (no fp8 library), so the model is
independent of what it is checked against: ``ml_dtypes`` (what
``jnp.astype`` does), ``jnp.astype`` on the CPU, and the port's
``ops/rounding.astype_storage``. All must give the same codes, except NaN
payloads (a NaN input gives a NaN; its code is not compared). On the card,
``chip_smoke.py`` holds the kernel's narrowing itself against
``astype_storage`` on every f32 bit pattern (``check_fp8_narrowing``).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from cachedembedding_tpu_torch.ops.rounding import astype_storage

# name -> (mantissa bits, exponent bias, largest finite code, the code past it, largest finite value)
FORMATS = {
    "float8_e4m3fn": (3, 7, 0x7E, 0x7F, 448.0),  # 0x7F: NaN
    "float8_e5m2": (2, 15, 0x7B, 0x7C, 57344.0),  # 0x7C: inf
}
NAN_CODE = 0x7F


def _rne_codes(x: np.ndarray, name: str) -> np.ndarray:
    """Codes (sign apart) of |x| rounded to nearest even on the format's
    grid, with no upper limit (a code past the largest finite one means
    only "beyond it"). x: finite float32."""
    mbits, bias, _, _, _ = FORMATS[name]
    a = np.abs(x.astype(np.float64))
    emin = 1 - bias
    _, e = np.frexp(a)
    e = np.where(a > 0, np.maximum(e - 1, emin), emin)  # a = m * 2^e, m in [1, 2); below, emin's step
    q = np.rint(a / np.ldexp(1.0, e - mbits))  # exact quotient of an f32 by a power of two; rint ties to even
    return ((e - emin) * 2**mbits + q).astype(np.int64)


def satfinite(x: np.ndarray, name: str) -> np.ndarray:
    """``cvt.rn.satfinite``: round to nearest even, clamped to +-the largest
    finite value (+-inf too); NaN gives NaN."""
    _, _, max_code, _, _ = FORMATS[name]
    fin = np.isfinite(x)
    code = np.where(fin, np.minimum(_rne_codes(np.where(fin, x, 0), name), max_code), max_code)
    code = np.where(np.isnan(x), NAN_CODE, code)
    return (code | np.where(np.signbit(x), 0x80, 0)).astype(np.uint8)


def nosat(x: np.ndarray, name: str) -> np.ndarray:
    """The no-saturation cast: round to nearest even; past the largest
    finite value e4m3fn gives NaN and e5m2 inf; NaN gives NaN."""
    _, _, _, over_code, _ = FORMATS[name]
    fin = np.isfinite(x)
    code = np.where(fin, np.minimum(_rne_codes(np.where(fin, x, 0), name), over_code), over_code)
    code = np.where(np.isnan(x), NAN_CODE, code)
    return (code | np.where(np.signbit(x), 0x80, 0)).astype(np.uint8)


def narrow_model(x: np.ndarray, name: str) -> np.ndarray:
    """The kernels' narrowing: the card's saturating conversion where |x| <=
    the largest finite value, the no-saturation cast elsewhere (NaN
    included: it fails the comparison)."""
    inside = np.abs(x) <= FORMATS[name][4]
    return np.where(inside, satfinite(x, name), nosat(x, name))


def _f32(bits) -> np.ndarray:
    return np.asarray(bits, dtype=np.uint32).view(np.float32)


def _around(v: float) -> list:
    """v and its f32 neighbours, both signs."""
    x = np.float32(v)
    near = [np.nextafter(x, np.float32(-np.inf)), x, np.nextafter(x, np.float32(np.inf))]
    return [s * y for y in near for s in (1, -1)]


def _every_exponent() -> np.ndarray:
    """Every f32 exponent (subnormals, normals, inf/NaN's), both signs, with
    mantissas 0, all ones, and 61 seeded ones."""
    rng = np.random.default_rng(0)
    mant = np.concatenate([[0, (1 << 23) - 1], rng.integers(1, 1 << 23, 61)]).astype(np.uint32)
    exps = np.arange(256, dtype=np.uint32)
    bits = (exps[:, None] << 23 | mant[None, :]).reshape(-1)
    return _f32(np.concatenate([bits, bits | np.uint32(1 << 31)]))


def _thresholds(name: str) -> np.ndarray:
    """448, 464, 57,344, 61,440, the format's largest finite value and the
    midpoint past it, each +-1 f32 ulp and both signs."""
    max_finite = FORMATS[name][4]
    step = max_finite / 7 if name == "float8_e4m3fn" else max_finite / 14  # the top binade's step: 64, 4096
    vals = {448.0, 464.0, 57344.0, 61440.0, max_finite, max_finite + step / 2}
    return np.asarray([y for v in sorted(vals) for y in _around(v)], np.float32)


def _ties(name: str) -> np.ndarray:
    """Every finite code's value and the midpoints between neighbouring
    codes (ties to even), each +-1 f32 ulp and both signs."""
    dt = getattr(ml_dtypes, name)
    vals = np.arange(0x80, dtype=np.uint8).view(dt).astype(np.float32)
    vals = np.sort(vals[np.isfinite(vals)])
    mids = (vals[:-1].astype(np.float64) + vals[1:]) / 2
    return np.asarray([y for v in np.concatenate([vals, mids]) for y in _around(float(v))], np.float32)


def _subnormals(name: str) -> np.ndarray:
    """The format's subnormal range and below (seeded), f32 subnormals, and
    signed zeros."""
    mbits, bias, _, _, _ = FORMATS[name]
    rng = np.random.default_rng(1)
    min_normal = 2.0 ** (1 - bias)
    x = rng.random(4096) * 2 * min_normal
    x[:1024] *= 2.0 ** -mbits  # around the smallest subnormal
    f32_sub = _f32(rng.integers(1, 1 << 23, 256))
    vals = np.concatenate([x.astype(np.float32), f32_sub, [0.0, np.float32(1e-45)]]).astype(np.float32)
    return np.concatenate([vals, -vals])


def _specials() -> np.ndarray:
    nans = _f32([0x7FC00000, 0x7F800001, 0x7FFFFFFF, 0xFFC00000, 0xFF800001])
    return np.concatenate([np.asarray([np.inf, -np.inf, 0.0, -0.0, 3.0e38, -3.0e38], np.float32), nans])


CLASSES = {
    "every_exponent": lambda name: _every_exponent(),
    "thresholds": _thresholds,
    "ties": _ties,
    "subnormals": _subnormals,
    "specials": lambda name: _specials(),
}


def _codes_equal(got: np.ndarray, want: np.ndarray, x: np.ndarray, what: str) -> None:
    """Equal codes, except that a NaN input only needs a NaN out (payloads
    and signs of NaN are not compared)."""
    nan_in = np.isnan(x)
    got_nan = (got & 0x7F) == NAN_CODE
    assert got_nan[nan_in].all(), f"{what}: a NaN input did not give NaN"
    bad = np.nonzero((got != want) & ~nan_in)[0]
    assert bad.size == 0, (f"{what}: {bad.size} codes differ, e.g. x = {x[bad[:4]].tolist()} -> "
                           f"{[hex(c) for c in got[bad[:4]]]} vs {[hex(c) for c in want[bad[:4]]]}")


@pytest.mark.parametrize("cls", list(CLASSES))
@pytest.mark.parametrize("name", list(FORMATS))
def test_model_matches_jax_and_astype_storage(name, cls):
    """The kernels' two-branch narrowing, modelled, gives ml_dtypes' codes
    (what jnp.astype does), jnp.astype's on the CPU and astype_storage's,
    for every f32 exponent, the thresholds, every tie, subnormals and the
    special values."""
    x = CLASSES[cls](name)
    dt = getattr(ml_dtypes, name)
    got = narrow_model(x, name)
    with np.errstate(invalid="ignore"):  # NaN and inf inputs
        ref = x.astype(dt).view(np.uint8)
    _codes_equal(got, ref, x, f"model vs ml_dtypes ({name}, {cls})")
    jx = np.asarray(jnp.asarray(x).astype(getattr(jnp, name))).view(np.uint8)
    _codes_equal(got, jx, x, f"model vs jnp.astype ({name}, {cls})")
    port = astype_storage(torch.from_numpy(x.copy()), getattr(torch, name)).view(torch.uint8).numpy()
    _codes_equal(got, port, x, f"model vs astype_storage ({name}, {cls})")


@pytest.mark.parametrize("name", list(FORMATS))
def test_saturating_branch_alone_is_wrong_beyond_the_largest_finite_value(name):
    """The card's saturating conversion alone (the fault the no-saturation
    branch repairs) clamps to +-448 or +-57,344 where JAX gives NaN or inf;
    inside the largest finite value it equals the no-saturation cast."""
    x = _every_exponent()
    x = x[np.isfinite(x)]
    big = np.abs(x) > {"float8_e4m3fn": 464.0, "float8_e5m2": 61440.0}[name]
    ref = x.astype(getattr(ml_dtypes, name)).view(np.uint8)
    sat = satfinite(x, name)
    assert (sat[big] & 0x7F == FORMATS[name][2]).all()
    assert (sat[big] != ref[big]).all()
    inside = np.abs(x) <= FORMATS[name][4]
    np.testing.assert_array_equal(sat[inside], nosat(x, name)[inside])


@pytest.mark.parametrize("name", list(FORMATS))
def test_no_saturation_branch_codes(name):
    """What the no-saturation branch gives just past the largest finite
    value: the largest finite code below the midpoint (464 for e4m3fn,
    61,440 for e5m2), the even neighbour on it (448, whose code is even, and
    inf, since 57,344's is odd), then NaN (e4m3fn) or inf (e5m2), signed,
    as astype_storage does."""
    _, _, max_code, over_code, max_finite = FORMATS[name]
    mid = {"float8_e4m3fn": 464.0, "float8_e5m2": 61440.0}[name]
    x = np.asarray([np.nextafter(np.float32(max_finite), np.float32(np.inf)), mid,
                    np.nextafter(np.float32(mid), np.float32(np.inf)), np.inf], np.float32)
    e5m2 = name == "float8_e5m2"
    want = np.asarray([max_code, over_code if e5m2 else max_code, over_code, over_code if e5m2 else NAN_CODE],
                      np.uint8)
    for sign in (1, -1):
        got = narrow_model(sign * x, name)
        np.testing.assert_array_equal(got, want | (0x80 if sign < 0 else 0))
        port = astype_storage(torch.from_numpy(sign * x), getattr(torch, name)).view(torch.uint8).numpy()
        np.testing.assert_array_equal(port & 0x7F, want & 0x7F)
