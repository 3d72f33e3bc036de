"""The window wire: what a window ships from the host to the device in one
transfer, and how the device lands it (the JAX trainer keeps these in
``cachedembedding_tpu/train/trainer.py``; the port keeps them here).

A window is one uint8 buffer, copied to the device once::

    [ids | dense meta | dense | labels | synth admits | fetched admits | plans]

  * **ids** (uniform windows): per-feature blocks at their own widths
    (``pf_pack_spec``), plain, escape-coded or rank-tier coded
    (``WindowWire``); a bag without a per-feature spec ships one fixed width
    (``hostops.id_pack_width``). Ragged windows ship the (P, Vp) padded
    stream at a fixed width, then the per-bag lengths as u8 or u16.
  * **dense**: f32, bf16, range-scaled uint8 with one (scale, lo) pair per
    window, or nibble-packed int4 with a pair per feature.
  * **labels**: one bit each when binary and P*B % 8 == 0 (uniform), else u8.
  * **admits**: synthesized (slot, row, bound) triples, then fetched slots,
    payload (f32, bf16, int8 or int4 rows), their scales and their Adagrad
    accumulators. The port ships exact counts, not JAX's padded buckets.
  * **plans** (the port's own): each step's row-sorted update plan, at a
    16-byte aligned offset at the end.

Everything up to the admits is JAX's byte layout. The decoders are torch
integer ops (shifts, masks, cumsums, gathers) with JAX's results on the same
bytes; f32 and int32 fields at offsets that are not 4-aligned are copied out
before they are reinterpreted.
"""

from __future__ import annotations

from itertools import combinations
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from cachedembedding_tpu_torch._native import hostops

# ---------------------------------------------------------------------------
# host: dense features


def quant_dense_window(dense: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Range-scaled uint8 dense wire of a (P, B, Din) window: one (scale, lo)
    f32 pair for the whole window (JAX ``_quant_dense_window``)."""
    raw = np.asarray(dense, np.float32)
    lo = float(raw.min())
    scale = (float(raw.max()) - lo) / 255.0 or 1.0
    q = np.round((raw - lo) / scale).astype(np.uint8)
    return q, np.array([scale, lo], np.float32)


def quant_dense_window4(dense: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Nibble-packed int4 dense wire with a (scale, lo) pair per feature;
    Din is zero-padded to even, element 2k in the low nibble (JAX
    ``_quant_dense_window4``). Returns (packed (P, B, Dp/2), meta (2*Dp,))."""
    raw = np.asarray(dense, np.float32)
    P, B, Din = raw.shape
    Dp = Din + (Din & 1)
    lo = raw.min(axis=(0, 1))
    scale = (raw.max(axis=(0, 1)) - lo) / 15.0
    scale[scale == 0.0] = 1.0
    q = np.round((raw - lo) / scale).astype(np.uint8)
    if Dp != Din:
        q = np.concatenate([q, np.zeros((P, B, 1), np.uint8)], axis=2)
    packed = q[:, :, 0::2] | (q[:, :, 1::2] << 4)
    meta = np.zeros((2, Dp), np.float32)
    meta[0, :Din] = scale
    meta[1, :Din] = lo
    return packed, meta.reshape(-1)


def dense_wire(dense: np.ndarray, dmode: str) -> list:
    """The dense block of a (P, B, Din) f32 window in ``dmode``: a list of
    uint8 arrays (meta first where the mode has one)."""
    if dmode == "int8":
        q, meta = quant_dense_window(dense)
        return [meta.view(np.uint8), q.reshape(-1)]
    if dmode == "int4":
        q, meta = quant_dense_window4(dense)
        return [meta.view(np.uint8), q.reshape(-1)]
    if dmode == "bfloat16":
        return [torch.from_numpy(np.ascontiguousarray(dense, np.float32)).to(torch.bfloat16)
                .view(torch.uint8).numpy().reshape(-1)]
    if dmode == "float32":
        return [np.ascontiguousarray(dense, np.float32).reshape(-1).view(np.uint8)]
    raise ValueError(f"unknown dense_input_dtype {dmode!r}")


def dense_reference(dense: np.ndarray, dmode: str) -> np.ndarray:
    """What the device decodes from ``dense_wire(dense, dmode)``, computed on
    the host in numpy: the f32 features for int8/int4 are q * scale + lo
    rounded once (float64, then f32)."""
    dense = np.asarray(dense, np.float32)
    if dmode == "int8":
        q, meta = quant_dense_window(dense)
        return (q.astype(np.float64) * np.float64(meta[0]) + np.float64(meta[1])).astype(np.float32)
    if dmode == "int4":
        q, meta = quant_dense_window4(dense)
        P, B, _ = q.shape
        m = meta.reshape(2, -1).astype(np.float64)
        qq = np.stack([q & 0xF, q >> 4], axis=-1).reshape(P, B, -1).astype(np.float64)
        return (qq * m[0] + m[1]).astype(np.float32)[:, :, : dense.shape[2]]
    if dmode == "bfloat16":
        return torch.from_numpy(dense).to(torch.bfloat16).float().numpy()
    return dense


def label_wire(labels: np.ndarray, allow_bits: bool) -> Tuple[np.ndarray, bool]:
    """(P, B) labels as u8, or one bit each (little-endian bit order) when
    ``allow_bits``, they are binary and P*B % 8 == 0. Returns (bytes, bits)."""
    lab = np.asarray(labels).astype(np.uint8)
    if allow_bits and lab.size % 8 == 0 and lab.max(initial=0) <= 1:
        return np.packbits(lab.reshape(-1), bitorder="little"), True
    return lab.reshape(-1), False


# ---------------------------------------------------------------------------
# device: field access and the decoders


def field(buf: torch.Tensor, a: int, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``n`` elements of ``dtype`` at byte offset ``a`` of a uint8 buffer: a
    view where the offset is aligned to the element size, else a copy."""
    size = torch.empty((), dtype=dtype).element_size()
    seg = buf[a : a + n * size]
    if size > 1 and a % size:
        seg = seg.clone()
    return seg.view(dtype)


def fma_f32(q: torch.Tensor, s: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """f32 ``q * s + lo`` rounded once, as XLA's fused multiply-add computes
    it on the CPU. The product is exact in float64; the sum is rounded to
    odd there (its error, from TwoSum, nudges an even result one float64
    step towards the exact value), and rounding to odd at 53 bits and then to
    f32 equals one rounding of the exact value."""
    a = q.double() * s.double()
    b = lo.double()
    t = a + b
    bb = t - a
    err = (a - (t - bb)) + (b - bb)
    even = (t.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(t, float("inf")), torch.full_like(t, float("-inf")))
    t = torch.where((err != 0) & even, torch.nextafter(t, toward), t)
    return t.float()


def unpack_flat(b: torch.Tensor, n: int, width: int) -> torch.Tensor:
    """Decode n ids bit-packed at a nibble-aligned width 4..32 (the inverse
    of ``hostops.pack_ids_any``; JAX ``_unpack_flat``): (n,) int32."""
    if width == 32:
        return (b.clone() if b.storage_offset() % 4 else b).view(torch.int32)
    u = b.to(torch.int32)
    if width == 8:
        return u
    if width == 16:
        u = u.reshape(n, 2)
        return u[:, 0] | (u[:, 1] << 8)
    if width == 24:
        u = u.reshape(n, 3)
        return u[:, 0] | (u[:, 1] << 8) | (u[:, 2] << 16)
    if width == 4:
        return torch.stack([u & 0xF, u >> 4], dim=-1).reshape(n)
    if width == 12:
        u = u.reshape(n // 2, 3)
        e0 = u[:, 0] | ((u[:, 1] & 0xF) << 8)
        e1 = (u[:, 1] >> 4) | (u[:, 2] << 4)
    elif width == 20:
        u = u.reshape(n // 2, 5)
        e0 = u[:, 0] | (u[:, 1] << 8) | ((u[:, 2] & 0xF) << 16)
        e1 = (u[:, 2] >> 4) | (u[:, 3] << 4) | (u[:, 4] << 12)
    elif width == 28:
        u = u.reshape(n // 2, 7)
        e0 = u[:, 0] | (u[:, 1] << 8) | (u[:, 2] << 16) | ((u[:, 3] & 0xF) << 24)
        e1 = (u[:, 3] >> 4) | (u[:, 4] << 4) | (u[:, 5] << 12) | (u[:, 6] << 20)
    else:
        raise ValueError(f"unsupported pack width {width}")
    return torch.stack([e0, e1], dim=-1).reshape(n)


def unpack_ids(b: torch.Tensor, P: int, L: int, width: int) -> torch.Tensor:
    """(P, L) int32 ids packed by ``hostops.pack_ids`` (16/20/24 bits) or raw
    (32) (JAX ``_unpack_ids``; 20 bits pairs over the flat stream, which is
    its (P, L//2, 5) blocks when L is even)."""
    return unpack_flat(b, P * L, width).reshape(P, L)


def _set_escapes(v: torch.Tensor, buf: torch.Tensor, a: int, ne: int) -> torch.Tensor:
    """Overwrite flat positions of ``v`` (P*L,) with the ``ne`` (u32 position,
    i32 value) escapes at ``a``; positions past the end (padding) drop."""
    pos = field(buf, a, ne, torch.int32).long()
    val = field(buf, a + 4 * ne, ne, torch.int32)
    n = v.shape[0]
    out = torch.cat([v, v.new_zeros(1)])
    out[torch.where((pos >= 0) & (pos < n), pos, n)] = val  # padding lands on the extra slot
    return out[:n]


def decode_window_ids(buf: torch.Tensor, P: int, L: int, id_spec) -> Tuple[torch.Tensor, int]:
    """Decode the id block at the start of a uniform window's buffer: (P, L)
    int32 ids and the block's end (JAX ``_decode_window_ids``). ``id_spec``
    is a fixed width (int), a per-feature ((w, delta), ...) tuple, ("esc",
    per-feature spec, escape budget) or ("rt", entries, escape budget)."""
    if isinstance(id_spec, int):
        a = P * {16: 2 * L, 20: 5 * (L // 2), 24: 3 * L, 32: 4 * L}[id_spec]
        return unpack_ids(buf[:a], P, L, id_spec), a
    ne = 0
    if id_spec[0] == "rt":
        _, entries, ne = id_spec
        Bf = L // len(entries)
        n = P * Bf
        a = 0
        cols = []
        for ent in entries:
            if ent[0] == "p":
                _, w, delta = ent
                nb = (n * w) // 8
                v = unpack_flat(buf[a : a + nb], n, w)
                a += nb
            else:
                v, a = _decode_tier(buf, a, n, ent)
                delta = ent[2]
            cols.append((v + delta if delta else v).reshape(P, Bf))
    else:
        if id_spec[0] == "esc":
            _, id_spec, ne = id_spec
        Bf = L // len(id_spec)
        n = P * Bf
        a = 0
        cols = []
        for w, delta in id_spec:
            nb = (n * w) // 8
            v = unpack_flat(buf[a : a + nb], n, w).reshape(P, Bf)
            cols.append(v + delta if delta else v)
            a += nb
    v = torch.stack(cols, dim=1).reshape(P * L)
    if ne:
        v = _set_escapes(v, buf, a, ne)
        a += 8 * ne
    return v.reshape(P, L), a


def _decode_tier(buf: torch.Tensor, a: int, n: int, ent) -> Tuple[torch.Tensor, int]:
    """One rank-tier feature block: the 2-bit selectors, the dictionary, and
    four substreams merged back to position order. Returns the (n,) symbols
    remapped through the dictionary (before the feature's delta)."""
    _, widths, _delta, caps, dict_k = ent
    u = buf[a : a + n // 4].to(torch.int32)
    a += n // 4
    sel = torch.stack([u & 3, (u >> 2) & 3, (u >> 4) & 3, (u >> 6) & 3], dim=-1).reshape(-1)
    dv = None
    if dict_k:
        dv = field(buf, a, dict_k, torch.int32)
        a += 4 * dict_k
    streams = []
    for ck, wk in zip(caps, widths):
        nb = (ck * wk) // 8
        streams.append(unpack_flat(buf[a : a + nb], ck, wk))
        a += nb
    T = torch.cat(streams)
    idx = torch.zeros((n,), dtype=torch.int64, device=buf.device)
    off = 0
    for k in range(4):
        mk = sel == k
        idx = torch.where(mk, torch.cumsum(mk, 0) - 1 + off, idx)  # k-th tier's running position
        off += caps[k]
    sym = T[torch.remainder(idx, T.shape[0])]
    if dv is None:
        return sym, a
    return torch.where(sel == 3, sym, dv[sym.clamp(0, dict_k - 1).long()]), a


def unpack_dense(buf: torch.Tensor, a: int, P: int, B: int, Din: int, dmode: str):
    """(P, B, Din) f32 dense features of the block at ``a``, and its end
    (JAX ``_unpack_dense``). int8/int4 decode as ``q * scale + lo`` rounded
    once (``fma_f32``)."""
    if dmode == "int4":
        Dp = Din + (Din & 1)
        meta = field(buf, a, 2 * Dp, torch.float32).reshape(2, Dp)
        a += 8 * Dp
        end = a + P * B * Dp // 2
        b = buf[a:end].reshape(P, B, Dp // 2).to(torch.int32)
        q = torch.stack([b & 0xF, b >> 4], dim=-1).reshape(P, B, Dp)
        return fma_f32(q, meta[0], meta[1])[:, :, :Din], end
    if dmode == "int8":
        meta = field(buf, a, 2, torch.float32)
        a += 8
        end = a + P * B * Din
        return fma_f32(buf[a:end].reshape(P, B, Din), meta[0], meta[1]), end
    dt = torch.bfloat16 if dmode == "bfloat16" else torch.float32
    size = 2 if dmode == "bfloat16" else 4
    end = a + P * B * Din * size
    return field(buf, a, P * B * Din, dt).reshape(P, B, Din).float(), end


def unpack_labels(buf: torch.Tensor, b: int, P: int, B: int, lbits: bool):
    """(P, B) f32 labels at ``b``, one bit each (little-endian) when
    ``lbits``, else u8; and the block's end (JAX ``_unpack_labels``)."""
    if not lbits:
        c = b + P * B
        return buf[b:c].reshape(P, B).float(), c
    c = b + (P * B) // 8
    by = buf[b:c].to(torch.int32)
    bits = (by[:, None] >> torch.arange(8, dtype=torch.int32, device=buf.device)[None, :]) & 1
    return bits.reshape(P, B).float(), c


def unpack_lengths(buf: torch.Tensor, a: int, P: int, n_bags: int, len16: bool):
    """(P, n_bags) int32 per-bag lengths of a ragged window at ``a`` (u8 or
    u16 little-endian), and the block's end (JAX ``_unpack_lengths``)."""
    if len16:
        end = a + P * n_bags * 2
        u = buf[a:end].to(torch.int32).reshape(P, n_bags, 2)
        return u[..., 0] | (u[..., 1] << 8), end
    end = a + P * n_bags
    return buf[a:end].reshape(P, n_bags).to(torch.int32), end


class AdmitLayout(NamedTuple):
    """Where a window's admits sit in its buffer and how they are coded."""

    offset: int  # byte offset of the synth block
    sb: int      # synthesized admits
    fb: int      # fetched admits
    fmode: str   # fetched payload: "float32" | "bfloat16" | "int8" | "int4"
    accum: bool  # fetched rows carry their Adagrad accumulators


def admit_wire(ws, fmode: str, accum: bool) -> list:
    """The admit block of a staged window (``WindowStaging``), as uint8
    arrays: synth slots, rows and bounds, then fetched slots, payload,
    scales (int8/int4) and accumulators."""
    parts = []
    if ws.synth_slots.shape[0]:
        parts += [np.ascontiguousarray(ws.synth_slots, np.int32).view(np.uint8),
                  np.ascontiguousarray(ws.synth_rows, np.int32).view(np.uint8),
                  np.ascontiguousarray(ws.synth_bounds, np.float32).view(np.uint8)]
    if ws.fetch_slots.shape[0]:
        parts += [np.ascontiguousarray(ws.fetch_slots, np.int32).view(np.uint8),
                  ws.fetch_payload.contiguous().view(torch.uint8).numpy().reshape(-1)]
        if fmode in ("int8", "int4"):
            parts.append(np.ascontiguousarray(ws.fetch_scales, np.float32).view(np.uint8))
        if accum:
            parts.append(np.ascontiguousarray(ws.fetch_accum, np.float32).view(np.uint8))
    return parts


def apply_packed_admits(embed, buf: torch.Tensor, lay: AdmitLayout) -> None:
    """Decode a window's admits from its device buffer and land them
    (``embed.land_admits``; JAX ``_apply_packed_admits``): synthesized rows
    first, then fetched rows with their payload (f32, bf16, int8 or int4,
    dequantized to f32 and cast to the rows' dtype) and accumulators. The
    payload rows hold the columns the bag stores (``dim_stored``)."""
    D = embed.dim_stored
    c = lay.offset
    synth = fetch = None
    if lay.sb:
        sb = lay.sb
        synth = (field(buf, c, sb, torch.int32).long(), field(buf, c + 4 * sb, sb, torch.int32),
                 field(buf, c + 8 * sb, sb, torch.float32))
        c += 12 * sb
    if lay.fb:
        fb = lay.fb
        slots = field(buf, c, fb, torch.int32).long()
        c += 4 * fb
        scales = None
        if lay.fmode in ("int8", "int4"):
            n = fb * D // 2 if lay.fmode == "int4" else fb * D
            payload = buf[c : c + n].reshape(fb, -1)
            if lay.fmode == "int8":
                payload = payload.view(torch.int8)
            scales = field(buf, c + n, fb, torch.float32)
            c += n + 4 * fb
        else:
            dt = torch.bfloat16 if lay.fmode == "bfloat16" else torch.float32
            payload = field(buf, c, fb * D, dt).reshape(fb, D)
            c += fb * D * payload.element_size()
        fetch = (slots, payload, scales, field(buf, c, fb, torch.float32) if lay.accum else None)
    embed.land_admits(synth, fetch)


# ---------------------------------------------------------------------------
# host: the stateful id wires


class WindowWire:
    """The host encoder of a uniform window's id block (the JAX trainer's
    ``_escape_encode`` and ``_tier_encode`` with their learned state).

    ``id_wire``: "plain" ships each feature at its plain width; "escape"
    learns narrower base widths over the first ``_esc_learn_windows``
    windows, then ships them with a window-level list of escapes; "ranktier"
    skips ``_RT_SKIP_WINDOWS`` windows, learns until window
    ``_RT_LEARN_WINDOWS``, then ships per-feature tier selectors and
    substreams of dictionary ranks, its dictionaries re-ranked every
    ``_RT_REBUILD`` windows. A window that overflows the frozen budget or
    caps ships the plain format, as in JAX. ``encode`` returns (bytes,
    id_spec, format), the format one of "plain", "esc", "rt"."""

    _ESC_WIDTHS = (4, 8, 12, 16, 20, 24)
    _ESC_SUB = 8          # learning subsample stride
    _ESC_MAX_RATE = 0.05  # never narrow a feature past 5% overflow
    _ESC_BITS = 64        # wire cost of one escape (u32 position + i32 value)
    _RT_WIDTHS = (4, 8, 12, 16)
    _RT_SKIP_WINDOWS = 12
    _RT_LEARN_WINDOWS = 24
    _RT_CAP_MARGIN = 1.06
    _RT_T3_MARGIN = 1.5
    _RT_FALLBACK_RESET = 4
    _RT_DICT_W = 12
    _RT_REBUILD = 8

    def __init__(self, id_wire: str, escape_pack: bool, dict_features, device_rows: int):
        if id_wire not in ("plain", "escape", "ranktier"):
            raise ValueError(f"unknown id_wire {id_wire!r}")
        self.id_wire = id_wire
        self._escape_pack = bool(escape_pack) and id_wire != "plain"
        self._dict_features = list(dict_features)  # per feature: ranks through a dictionary
        self._device_rows = int(device_rows)
        self._esc_learn_windows = 12
        self._esc_seen = 0
        self._esc_counts = None
        self._esc_totals = 0
        self._esc_spec = None        # frozen ("esc", spec, ne), or False
        self._esc_plain_spec = None
        self._rt_seen = 0
        self._rt_skip = 0
        self._rt_stats = None
        self._rt_spec = None         # frozen entries, or False
        self._rt_ne = 0
        self._rt_caps = {}           # n -> (F, 4) caps of the frozen spec
        self._rt_encoder = None      # one native state for every window size
        self._rt_encoder_spec = None
        self._rt_last_n = None
        self._rt_enc_windows = 0
        self._rt_overflows = 0

    def encode(self, slot3: np.ndarray, spec, P: int, L: int, Bf: int):
        if self.id_wire == "ranktier":
            return self._tier_encode(slot3, spec, P, L, Bf)
        return self._escape_encode(slot3, spec, P, L, Bf)

    @staticmethod
    def _plain(slot3: np.ndarray, spec):
        ws = np.array([w for w, _ in spec], np.int32)
        ds = np.array([d for _, d in spec], np.int32)
        out, _, _ = hostops.escape_pack_window(slot3, ws, ws, ds, 0)
        return out, tuple(spec), "plain"

    # -- escape ---------------------------------------------------------------
    def _escape_encode(self, slot3, spec, P: int, L: int, Bf: int):
        n = P * Bf
        if self._escape_pack and self._esc_spec is None:
            sub = slot3[:, :, :: self._ESC_SUB]
            if self._esc_counts is None:
                self._esc_counts = np.zeros((len(spec), len(self._ESC_WIDTHS)), np.int64)
            for f, (w, delta) in enumerate(spec):
                local = sub[:, f, :].reshape(-1)
                if delta:
                    local = local - delta
                for k, wc in enumerate(self._ESC_WIDTHS):
                    if wc >= w:
                        break
                    self._esc_counts[f, k] += int((local >= (1 << wc)).sum())
            self._esc_totals += sub.shape[0] * sub.shape[2]
            self._esc_seen += 1
            if self._esc_seen >= self._esc_learn_windows:
                self._freeze_escape_spec(spec, n, Bf)
        if self._esc_spec:
            out = self._try_escape_encode(slot3, P, L, Bf)
            if out is not None:
                return out
        return self._plain(slot3, spec)

    def _freeze_escape_spec(self, plain_spec, n: int, Bf: int) -> None:
        """Each feature's base width minimizing width + overflow rate x escape
        bits (at most 5% overflow); odd-nibble widths only for an even Bf."""
        tot = max(self._esc_totals, 1)
        spec = []
        exp_escapes = 0.0
        pairs_ok = Bf % 2 == 0
        for f, (w, delta) in enumerate(plain_spec):
            best_w, best_cost = w, float(w)
            for k, wc in enumerate(self._ESC_WIDTHS):
                if wc >= w:
                    break
                if wc % 8 and not pairs_ok:
                    continue
                rate = self._esc_counts[f, k] / tot
                cost = wc + rate * self._ESC_BITS
                if rate <= self._ESC_MAX_RATE and cost < best_cost:
                    best_w, best_cost = wc, cost
            if best_w < w:
                exp_escapes += self._esc_counts[f, self._ESC_WIDTHS.index(best_w)] / tot * n
            spec.append((best_w, delta))
        if all(w == pw for (w, _), (pw, _) in zip(spec, plain_spec)):
            self._esc_spec = False
            return
        self._esc_plain_spec = tuple(plain_spec)
        self._esc_spec = ("esc", tuple(spec), int(2.0 * exp_escapes) + 512)

    def _try_escape_encode(self, slot3, P: int, L: int, Bf: int):
        """The frozen escape format, or None when the window's escapes exceed
        the budget."""
        _, spec, ne = self._esc_spec
        res = hostops.escape_pack_window(
            slot3, [w for w, _ in spec], [w for w, _ in self._esc_plain_spec], [d for _, d in spec], ne)
        if res is None:
            return None
        packed, epos, evals = res
        pos = np.full((ne,), P * L, np.uint32)
        val = np.zeros((ne,), np.int32)
        pos[: epos.shape[0]] = epos
        val[: evals.shape[0]] = evals
        return np.concatenate([packed, pos.view(np.uint8), val.view(np.uint8)]), self._esc_spec, "esc"

    # -- rank-tier ------------------------------------------------------------
    @staticmethod
    def _rt_rank_sym(vals: np.ndarray, dict_k: int):
        """sym[i] = frequency rank (hot -> 0) of vals[i] among the window's top
        dict_k - 1 values, -1 otherwise; and the (dict_k,) rank -> value table."""
        uniq, inv, cnt = np.unique(vals, return_inverse=True, return_counts=True)
        k = min(dict_k - 1, uniq.size)
        if uniq.size > k:
            part = np.argpartition(cnt, uniq.size - k)[-k:]
            order = part[np.argsort(-cnt[part], kind="stable")]
        else:
            order = np.argsort(-cnt, kind="stable")
        rank_of_uniq = np.full(uniq.size, -1, np.int64)
        rank_of_uniq[order] = np.arange(order.size)
        dv = np.zeros((dict_k,), np.int32)
        dv[: order.size] = uniq[order]
        return rank_of_uniq[inv.reshape(-1)], dv

    def _tier_learn(self, slot3, spec, P: int, Bf: int) -> None:
        F = len(spec)
        if self._rt_stats is None:
            self._rt_stats = {"ge": np.zeros((F, len(self._RT_WIDTHS)), np.int64),
                              "t3": np.zeros((F,), np.int64), "n": 0}
        dictf = self._dict_features
        st = self._rt_stats
        for f, (w, delta) in enumerate(spec):
            vals = slot3[:, f, :].reshape(-1)
            if dictf[f] and w > 4:
                sym, _ = self._rt_rank_sym(vals, 1 << self._RT_DICT_W)
                st["t3"][f] += int((sym < 0).sum())
                sym = sym[sym >= 0]
            else:
                sym = (vals - delta) if delta else vals
            for k, wc in enumerate(self._RT_WIDTHS):
                if wc >= w:
                    break
                st["ge"][f, k] += int((sym >= (1 << wc)).sum())
        st["n"] += P * Bf
        self._rt_seen += 1
        if self._rt_seen >= self._RT_LEARN_WINDOWS - self._RT_SKIP_WINDOWS:
            self._tier_freeze(spec)

    def _tier_freeze(self, spec) -> None:
        """Per feature, the cheaper of tier coding and escape-narrowed plain,
        both costed from the learned histograms; False when nothing gains."""
        st = self._rt_stats
        n_tot = max(st["n"], 1)
        dictf = self._dict_features
        WS = self._RT_WIDTHS
        entries = []
        exp_escapes = 0.0
        any_win = False
        for f, (w, delta) in enumerate(spec):
            ge = st["ge"][f] / n_tot
            t3_dict = st["t3"][f] / n_tot
            use_dict = dictf[f] and w > 4
            p_ge = {wc: (ge[k] if wc < w else 0.0) for k, wc in enumerate(WS)}
            esc_w, esc_cost = w, float(w)
            for k, wc in enumerate(WS):
                if wc >= w or use_dict:
                    break
                rate = ge[k]
                if rate <= self._ESC_MAX_RATE and wc + rate * self._ESC_BITS < esc_cost:
                    esc_w, esc_cost = wc, wc + rate * self._ESC_BITS
            best = None
            cand = [wc for wc in WS if wc < w and (not use_dict or wc <= self._RT_DICT_W)]

            def pge(wc):
                return p_ge[wc] if wc < w else 0.0

            n_win = n_tot / max(self._rt_seen, 1)
            for r in (1, 2, 3):
                for combo in combinations(cand, r):
                    widths = tuple(combo) + (w,) * (3 - r)
                    if use_dict:
                        wl = widths[r - 1]
                        s = (1.0 - t3_dict - pge(widths[0]),
                             (pge(widths[0]) - pge(widths[1])) if r >= 2 else 0.0,
                             (pge(widths[1]) - pge(widths[2])) if r >= 3 else 0.0,
                             t3_dict + pge(wl))
                    else:
                        s = (1.0 - pge(widths[0]), pge(widths[0]) - pge(widths[1]),
                             pge(widths[1]) - pge(widths[2]), pge(widths[2]))
                    cost = 2.0 + sum(sk * wk for sk, wk in zip(s[:3], widths)) + s[3] * w
                    if use_dict:
                        cost += 32.0 * (1 << widths[r - 1]) / n_win
                    if best is None or cost < best[0]:
                        best = (cost, widths + (w,), s, (1 << widths[r - 1]) if use_dict else 0)
            if best is not None and best[0] < min(esc_cost, w) - 0.25:
                _, widths, shares, dict_k = best
                entries.append(("t", widths, delta, shares, dict_k))
                any_win = True
            elif esc_w < w:
                entries.append(("p", esc_w, delta, w))
                exp_escapes += p_ge[esc_w]
                any_win = True
            else:
                entries.append(("p", w, delta, w))
        if not any_win:
            self._rt_spec = False
            return
        self._rt_ne = int(2.0 * exp_escapes * (n_tot / self._rt_seen)) + 512
        self._rt_spec = tuple(entries)

    @classmethod
    def _rt_cap(cls, share: float, n: int, margin: Optional[float] = None) -> int:
        m = cls._RT_CAP_MARGIN if margin is None else margin
        c = int(np.ceil(share * n * m)) + 256
        return min(c + (c % 2), n + (n % 2))

    def _relearn(self) -> None:
        self._rt_spec = None
        self._rt_stats = None
        self._rt_seen = 0
        self._rt_skip = self._RT_SKIP_WINDOWS  # already warm
        self._rt_overflows = 0

    def _tier_encode(self, slot3, spec, P: int, L: int, Bf: int):
        n = P * Bf
        if self._rt_spec is None and n % 4 == 0:
            self._rt_skip += 1
            if self._rt_skip > self._RT_SKIP_WINDOWS:
                self._tier_learn(slot3, spec, P, Bf)
        if not self._rt_spec or n % 4:
            return self._plain(slot3, spec)
        fresh = self._rt_encoder_spec is not self._rt_spec
        if fresh:  # caps and native state follow the spec object (freeze, relearn)
            self._rt_caps = {}
            self._rt_encoder = hostops.RankTierEncoder(self._rt_spec, self._device_rows)
            self._rt_encoder_spec = self._rt_spec
        caps = self._rt_caps.get(n)
        if caps is None:
            caps = np.array([[self._rt_cap(s, n, self._RT_T3_MARGIN if k == 3 else None)
                              for k, s in enumerate(ent[3])] if ent[0] == "t" else [0, 0, 0, 0]
                             for ent in self._rt_spec], np.int32)
            self._rt_caps[n] = caps
        # a fresh state has empty dictionaries; JAX keeps a state per window
        # size, so a new size rebuilds there too
        rebuild = fresh or n != self._rt_last_n or self._rt_enc_windows % self._RT_REBUILD == 0
        self._rt_last_n = n
        self._rt_enc_windows += 1
        ne = self._rt_ne
        res = self._rt_encoder.encode(slot3, caps, ne, rebuild)
        if isinstance(res, str):  # escapes over the budget
            return self._plain(slot3, spec)
        if isinstance(res[0], str):  # a tier cap overflowed: the stream drifted
            self._rt_overflows += 1
            if self._rt_overflows >= self._RT_FALLBACK_RESET:
                self._relearn()
            return self._plain(slot3, spec)
        self._rt_overflows = 0
        fblocks, opos, oval = res
        entries = tuple(("p", ent[1], ent[2]) if ent[0] == "p"
                        else ("t", tuple(ent[1]), ent[2], tuple(int(c) for c in caps[f]), ent[4])
                        for f, ent in enumerate(self._rt_spec))
        pos = np.full((ne,), P * L, np.uint32)
        val = np.zeros((ne,), np.int32)
        pos[: opos.size] = opos
        val[: oval.size] = oval
        return np.concatenate([fblocks, pos.view(np.uint8), val.view(np.uint8)]), ("rt", entries, ne), "rt"


def assemble(parts: list, tail: list, pin: bool) -> Tuple[torch.Tensor, int]:
    """One uint8 host buffer holding ``parts`` back to back, then ``tail`` at
    the next 16-byte aligned offset (pinned when ``pin``, so that its copy to
    the device never waits on earlier device work). Returns (buffer, tail
    offset)."""
    head = sum(p.nbytes for p in parts)
    tail_at = -(-head // 16) * 16 if tail else head
    total = tail_at + sum(p.nbytes for p in tail)
    buf = torch.empty((total,), dtype=torch.uint8, pin_memory=pin)
    out = buf.numpy()
    a = 0
    for p in parts:
        out[a : a + p.nbytes] = p.reshape(-1).view(np.uint8)
        a += p.nbytes
    out[a:tail_at] = 0
    a = tail_at
    for p in tail:
        out[a : a + p.nbytes] = p.reshape(-1).view(np.uint8)
        a += p.nbytes
    return buf, tail_at
