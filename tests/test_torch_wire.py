"""The window wire of the port (``train/wire.py``, ``_native/hostops``)
against the JAX package's encoders and device decoders on the same inputs,
made from a seed with numpy, on the CPU.

Tolerance: none. Host-encoded bytes are bit-equal to JAX's encoders (its
native library for the escape and rank-tier wires), and the port's torch
decoders give bit-equal arrays to JAX's decoders (run on the CPU) on the same
bytes. Against JAX's numpy rank-tier encoder, which breaks dictionary rank
ties in another order, only the decoded ids are held equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cachedembedding_tpu.train.trainer as jt
from cachedembedding_tpu._native import hostops as jax_hostops
from cachedembedding_tpu_torch._native import hostops
from cachedembedding_tpu_torch.train import wire

WIDTHS = [4, 8, 12, 16, 20, 24, 28, 32]


def _u8(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint8))


def _ids(rng, n, width):
    hi = (1 << width) if width < 32 else (1 << 31)
    return rng.integers(0, hi, n, dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("width", WIDTHS)
def test_pack_ids_any_and_unpack_flat_match_jax(width):
    rng = np.random.default_rng(width)
    n = 1000
    ids = _ids(rng, n, width)
    got = hostops.pack_ids_any(ids, width)
    want = jax_hostops.pack_ids_any(ids, width)
    np.testing.assert_array_equal(got, want)
    assert hostops.pf_nbytes(n, width) == got.nbytes
    # decoded at an odd byte offset too: a 32-bit field is copied out there
    for pre in (0, 3):
        buf = _u8(np.concatenate([np.zeros(pre, np.uint8), got]))
        dec = wire.unpack_flat(buf[pre:], n, width).numpy()
        np.testing.assert_array_equal(dec, np.asarray(jt._unpack_flat(jnp.asarray(got), n, width)))
        np.testing.assert_array_equal(dec, ids)


@pytest.mark.parametrize("width", [16, 20, 24, 32])
def test_fixed_width_ids_match_jax(width):
    rng = np.random.default_rng(width)
    P, L = 3, 250
    ids = _ids(rng, (P, L), width).reshape(P, L)
    assert hostops.id_pack_width((1 << width) - 1 if width < 32 else 1 << 30, L) == (width if width < 32 else 32)
    packed = ids.reshape(-1).view(np.uint8) if width == 32 else hostops.pack_ids(ids, width)
    if width < 32:
        np.testing.assert_array_equal(packed, jax_hostops.pack_ids(ids, width))
    dec = wire.unpack_ids(_u8(packed), P, L, width).numpy()
    np.testing.assert_array_equal(dec, np.asarray(jt._unpack_ids(jnp.asarray(packed), P, L, width)))
    np.testing.assert_array_equal(dec, ids)


@pytest.mark.parametrize("n", [7, 8, 1000, 1001])
def test_widths_match_jax(n):
    for m in (2, 15, 16, 17, 4000, 1 << 20, (1 << 20) + 1, 1 << 24, 33_762_577):
        assert hostops.nibble_width(m, n) == jax_hostops.nibble_width(m, n)
        assert hostops.id_pack_width(m, n) == jax_hostops.id_pack_width(m, n)


@pytest.mark.parametrize("bits", [True, False])
def test_labels_match_jax(bits):
    rng = np.random.default_rng(1)
    P, B = 4, 64
    labels = rng.integers(0, 2, (P, B))
    packed, lbits = wire.label_wire(labels, bits)
    assert lbits == bits
    if bits:
        np.testing.assert_array_equal(packed, np.packbits(labels.astype(np.uint8).reshape(-1), bitorder="little"))
    buf = np.concatenate([np.zeros(5, np.uint8), packed])
    got, end = wire.unpack_labels(_u8(buf), 5, P, B, lbits)
    want, jend = jt._unpack_labels(jnp.asarray(buf), 5, P, B, lbits)
    assert end == jend == buf.nbytes
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), labels.astype(np.float32))


@pytest.mark.parametrize("len16", [False, True])
def test_lengths_match_jax(len16):
    rng = np.random.default_rng(2)
    P, nb = 3, 40
    lens = rng.integers(0, 300 if len16 else 256, (P, nb))
    raw = lens.astype("<u2").reshape(-1).view(np.uint8) if len16 else lens.astype(np.uint8).reshape(-1)
    buf = np.concatenate([np.zeros(3, np.uint8), raw])
    got, end = wire.unpack_lengths(_u8(buf), 3, P, nb, len16)
    want, jend = jt._unpack_lengths(jnp.asarray(buf), 3, P, nb, len16)
    assert end == jend
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), lens)


class _B:
    def __init__(self, d):
        self.dense_features = d


def _dense(seed, P, B, Din):
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.1, 100, Din).astype(np.float32)
    shift = rng.uniform(-50, 50, Din).astype(np.float32)
    return (rng.standard_normal((P, B, Din)) * scale + shift).astype(np.float32)


@pytest.mark.parametrize("din", [13, 4])
@pytest.mark.parametrize("mode", ["bfloat16", "float32", "int8", "int4"])
def test_dense_wire_matches_jax(mode, din):
    """Bytes bit-equal to JAX's (its quantizers for int8/int4), decoded
    features bit-equal to its ``_unpack_dense`` at an unaligned offset. XLA
    computes the int8/int4 decode ``q * scale + lo`` as one fused
    multiply-add on the CPU; the port rounds it once too, where the same
    product and add rounded twice differ in a share of the elements."""
    P, B = 4, 64
    dense = _dense(din, P, B, din)
    parts = wire.dense_wire(dense, mode)
    batches = [_B(d) for d in dense]
    if mode == "int8":
        q, meta = jt._quant_dense_window(batches)
        want_bytes = np.concatenate([meta.view(np.uint8), q.reshape(-1)])
    elif mode == "int4":
        q, meta = jt._quant_dense_window4(batches)
        want_bytes = np.concatenate([meta.view(np.uint8), q.reshape(-1)])
    else:
        dt = jnp.bfloat16 if mode == "bfloat16" else np.float32
        want_bytes = np.asarray(jnp.asarray(dense, dt)).reshape(-1).view(np.uint8)
    got_bytes = np.concatenate(parts)
    np.testing.assert_array_equal(got_bytes, want_bytes)
    buf = np.concatenate([np.zeros(3, np.uint8), got_bytes])
    got, end = wire.unpack_dense(_u8(buf), 3, P, B, din, mode)
    want, jend = jax.jit(lambda x: jt._unpack_dense(x, 3, P, B, din, mode))(jnp.asarray(buf))
    want = np.asarray(want)
    assert end == int(jend) == buf.nbytes and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(got.numpy(), wire.dense_reference(dense, mode))
    if mode == "int8":
        twice = q.astype(np.float32) * meta[0] + meta[1]
        assert (twice != want).any()


def test_fma_rounds_once_like_xla():
    """``fma_f32`` against XLA's fused f32 ``q * s + lo`` on the CPU, on
    scales and offsets of very different magnitudes (where float64 alone
    would round twice)."""
    rng = np.random.default_rng(3)
    n = 200_000
    q = rng.integers(0, 256, n).astype(np.float32)
    s = (rng.random(n) * np.exp2(rng.integers(-30, 10, n))).astype(np.float32)
    lo = (rng.standard_normal(n) * np.exp2(rng.integers(-30, 30, n))).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b, c: a * b + c)(q, s, lo))
    got = wire.fma_f32(torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(lo)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# ---------------------------------------------------------------------------
# escape and rank-tier wires: the port's WindowWire against JAX's trainer
# methods, window by window

SPEC = ((16, 0), (16, 0), (12, 60_000), (4, 64_100))  # two cached, two resident features
DEVICE_ROWS = 64_110
DICT = [True, True, False, False]


def _window(rng, P=2, Bf=256, heavy=1.8):
    out = np.empty((P, len(SPEC), Bf), np.int32)
    for f, (w, delta) in enumerate(SPEC):
        hi = (DEVICE_ROWS - delta) if delta else 60_000
        hi = min(hi, 1 << w)
        out[:, f] = np.minimum(rng.zipf(heavy, (P, Bf)) - 1, hi - 1) + delta
    return out


def _jax_shim(dict_features=DICT, escape=True):
    """A JAX CachedDLRMTrainer's id-wire state and methods, without a
    trainer (as tests/test_ranktier.py builds it)."""
    s = type("Shim", (), {})()
    for name in dir(jt.CachedDLRMTrainer):
        if name.startswith(("_RT_", "_ESC_")):
            setattr(s, name, getattr(jt.CachedDLRMTrainer, name))
    s._escape_pack = escape
    s._esc_learn_windows, s._esc_seen, s._esc_counts, s._esc_totals, s._esc_spec = 12, 0, None, 0, None
    s._rt_stats, s._rt_seen, s._rt_spec, s._rt_ne = None, 0, None, 0
    s._rt_caps_cache, s._rt_encoders, s._rt_enc_windows = {}, {}, 0
    s._rt_dict_features = lambda F: list(dict_features)
    s._rt_rank_sym = jt.CachedDLRMTrainer._rt_rank_sym
    s._rt_cap = jt.CachedDLRMTrainer._rt_cap
    s._device_rows = lambda: DEVICE_ROWS
    for m in ("_escape_encode", "_freeze_escape_spec", "_try_escape_encode", "_tier_learn", "_tier_freeze",
              "_tier_encode", "_tier_encode_native"):
        setattr(s, m, getattr(jt.CachedDLRMTrainer, m).__get__(s))
    return s


def _decode_both(out, layout, P, L):
    got, end = wire.decode_window_ids(_u8(out), P, L, layout)
    want, jend = jt._decode_window_ids(jnp.asarray(out), (P, L, 0, 0, 0, layout))
    assert end == jend == out.nbytes
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    return got.numpy()


def _port_wire(id_wire):
    return wire.WindowWire(id_wire, True, DICT, DEVICE_ROWS)


def test_escape_wire_matches_jax_through_learn_freeze_and_overflow():
    """Plain bytes while learning (3 windows here, as the JAX tests shorten
    it), the escape format after the freeze, and the plain format again for
    a window whose escapes exceed the frozen budget: bytes and layouts equal
    to JAX's, ids decoded equal to JAX's and to the window."""
    rng = np.random.default_rng(11)
    js, pw = _jax_shim(), _port_wire("escape")
    js._esc_learn_windows = pw._esc_learn_windows = 3
    P, Bf = 2, 256
    L = len(SPEC) * Bf
    formats = []
    for i in range(8):
        slot3 = _window(rng, P, Bf) if i != 6 else _window(rng, P, Bf, heavy=1.3)
        if i == 7:  # every cached id escapes: over the budget
            slot3[:, :2] = 59_999
        out, layout, fmt = pw.encode(slot3, SPEC, P, L, Bf)
        jout, jlayout, jnb = js._escape_encode(slot3, SPEC, P, L, Bf)
        assert layout == jlayout, i
        np.testing.assert_array_equal(out, jout)
        assert out.nbytes == jnb
        np.testing.assert_array_equal(_decode_both(out, layout, P, L), slot3.reshape(P, L))
        formats.append(fmt)
    assert formats[:2] == ["plain"] * 2 and formats[2:7] == ["esc"] * 5 and formats[7] == "plain"
    assert pw._esc_spec[0] == "esc" and any(w < pw_ for (w, _), (pw_, _) in zip(pw._esc_spec[1], SPEC))


def _tight(spec):
    return tuple(("t", e[1], e[2], (0.0, 0.0, 0.0, 0.0), e[4]) if e[0] == "t" else e for e in spec)


def test_ranktier_wire_matches_jax_native_encoder():
    """Skip (12 windows), learn (through window 24), freeze, frozen windows with
    the dictionaries re-ranked every 8, then four windows over squeezed caps
    (the plain format; the fourth drops the spec and relearns from the next
    window): bytes and layouts equal to JAX's native encoder's."""
    rng = np.random.default_rng(12)
    js, pw = _jax_shim(), _port_wire("ranktier")
    P, Bf = 2, 256
    L = len(SPEC) * Bf
    formats = []
    for i in range(40):
        if i == 30:
            js._rt_spec = _tight(js._rt_spec)
            pw._rt_spec = _tight(pw._rt_spec)
        slot3 = _window(rng, P, Bf)
        out, layout, fmt = pw.encode(slot3, SPEC, P, L, Bf)
        jout, jlayout, jnb = js._tier_encode(slot3, SPEC, P, L, Bf)
        assert layout == jlayout, i
        np.testing.assert_array_equal(out, jout, err_msg=f"window {i}")
        assert out.nbytes == jnb
        np.testing.assert_array_equal(_decode_both(out, layout, P, L), slot3.reshape(P, L))
        formats.append(fmt)
        if i == 29:  # a frozen window: a dictionary feature ships tiered ranks
            assert any(e[0] == "t" and e[4] for e in layout[1])
    # window 13 is the first learned; the 12th learned (window 24) freezes and ships rank-tier
    assert formats[:23] == ["plain"] * 23 and formats[23:30] == ["rt"] * 7
    assert formats[30:34] == ["plain"] * 4  # cap overflows; the fourth relearns
    assert pw._rt_seen == js._rt_seen and (pw._rt_spec is None) == (js._rt_spec is None)


def test_ranktier_decodes_as_jax_numpy_encoder():
    """JAX's numpy rank-tier encoder orders dictionary ties otherwise; its
    bytes decode to the same ids as the port's."""
    rng = np.random.default_rng(13)
    js, pw = _jax_shim(), _port_wire("ranktier")
    P, Bf = 2, 256
    L = len(SPEC) * Bf
    for _ in range(25):
        slot3 = _window(rng, P, Bf)
        out, layout, _ = pw.encode(slot3, SPEC, P, L, Bf)
        js._tier_encode(slot3, SPEC, P, L, Bf)
    assert layout[0] == "rt"
    js._tier_encode_native = lambda *a, **k: None  # the numpy encoder
    for _ in range(3):
        slot3 = _window(rng, P, Bf)
        out, layout, _ = pw.encode(slot3, SPEC, P, L, Bf)
        jout, jlayout, _ = js._tier_encode(slot3, SPEC, P, L, Bf)
        assert layout == jlayout
        np.testing.assert_array_equal(_decode_both(out, layout, P, L), slot3.reshape(P, L))
        np.testing.assert_array_equal(_decode_both(jout, jlayout, P, L), slot3.reshape(P, L))


def test_ranktier_guards_out_of_range_ids():
    """A dictionary feature's id outside [0, max_val) raises (the JAX copy
    counts it unchecked)."""
    enc = hostops.RankTierEncoder((("t", (4, 8, 12, 16), 0, (0.5, 0.3, 0.1, 0.1), 16),), 100)
    slot3 = np.zeros((1, 1, 64), np.int32)
    caps = np.array([[64, 64, 64, 64]], np.int32)
    assert not isinstance(enc.encode(slot3, caps, 512, True)[0], str)
    slot3[0, 0, 7] = 150
    with pytest.raises(ValueError, match="out of range"):
        enc.encode(slot3, caps, 512, True)
    slot3[0, 0, 7] = -1
    with pytest.raises(ValueError, match="out of range"):
        enc.encode(slot3, caps, 512, False)


def test_ranktier_width_32_packs():
    """A tier entry whose last widths are 32 bits (ids past 2^28) packs and
    decodes; the JAX copy's ``1u << 32`` is undefined there."""
    rng = np.random.default_rng(14)
    P, Bf = 2, 128
    n = P * Bf
    slot3 = rng.integers(0, 1 << 31, (P, 1, Bf), dtype=np.int64).astype(np.int32)
    slot3[:, :, ::3] = rng.integers(0, 16, (P, 1, len(range(0, Bf, 3))))
    entry = ("t", (4, 8, 32, 32), 0, (0.4, 0.0, 0.6, 0.0), 0)
    enc = hostops.RankTierEncoder((entry,), 1 << 31)
    caps = np.array([[n, n, n, n]], np.int32)
    blocks, pos, _ = enc.encode(slot3, caps, 512, True)
    layout = ("rt", (("t", (4, 8, 32, 32), 0, tuple(int(c) for c in caps[0]), 0),), 16)
    buf = np.concatenate([blocks, np.full(16, P * Bf, np.uint32).view(np.uint8), np.zeros(16, np.int32).view(np.uint8)])
    got, _ = wire.decode_window_ids(_u8(buf), P, Bf, layout)
    np.testing.assert_array_equal(got.numpy(), slot3.reshape(P, Bf))


def test_ranktier_window_sizes_share_one_state():
    """Windows of two sizes share one native state (one set of rank arrays);
    the JAX trainer keeps one state a size. Both sizes decode exactly."""
    rng = np.random.default_rng(15)
    pw = _port_wire("ranktier")
    Bf = 256
    L = len(SPEC) * Bf
    for _ in range(24):
        pw.encode(_window(rng, 2, Bf), SPEC, 2, L, Bf)
    assert pw._rt_spec
    enc = None
    for P in (2, 4, 2, 4):
        slot3 = _window(rng, P, Bf)
        out, layout, fmt = pw.encode(slot3, SPEC, P, L, Bf)
        assert fmt == "rt"
        enc = enc or pw._rt_encoder
        assert pw._rt_encoder is enc
        np.testing.assert_array_equal(_decode_both(out, layout, P, L), slot3.reshape(P, L))


def test_escape_pack_window_matches_jax_native():
    rng = np.random.default_rng(16)
    slot3 = _window(rng, 3, 100)
    ws = np.array([8, 12, 8, 4], np.int32)
    pws = np.array([w for w, _ in SPEC], np.int32)
    ds = np.array([d for _, d in SPEC], np.int32)
    got = hostops.escape_pack_window(slot3, ws, pws, ds, 4096)
    want = jax_hostops.escape_pack_window(slot3, ws, pws, ds, 4096)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert hostops.escape_pack_window(slot3, ws, pws, ds, 0) is None
    assert jax_hostops.escape_pack_window(slot3, ws, pws, ds, 0) is False
