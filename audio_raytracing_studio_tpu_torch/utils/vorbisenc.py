"""Ogg/Vorbis encoder — the port's own copy of ``audio_raytracing_studio_tpu/
utils/vorbisenc.py`` (host code: NumPy and scipy's DCT, with the optional C++
packer of ``_native/vorbis_core.cc``, built at first use).

Counterpart of utils.vorbisio (the decoder); together they give the studio
a lossy conversion target with no external binaries (the reference's
analyser.py:73-83 writes .ogg through ffmpeg), and the stream is also
readable by the reference's own input path, libsndfile/soundfile.

Design: a deliberately small, fixed coding setup chosen for spec validity
and decode-anywhere interop rather than rate optimality —

* one blocksize (2048) for both block flags → a single mode, no window
  switching; the analysis window is the Vorbis window, which is
  power-complementary, so MDCT/IMDCT overlap-add reconstructs exactly;
* floor type 1 with a fixed 16-post log-spaced X list, multiplier 2
  (~1.09 dB resolution), every post value coded through one flat 7-bit
  scalar codebook (val = 0 is never emitted, so the decoder's step-2 flag
  list is always all-True and the rendered curve has a fixed segment
  structure the encoder can vectorize);
* residue type 1, partition size 32, four classes — silent / fine /
  medium+fine / coarse+medium+fine — cascading three 2-dim 256-entry
  product codebooks (16 uniform levels per component), classifications
  packed pairwise through a flat 4-bit classbook;
* no channel coupling (each channel coded independently).

The encoder builds its setup header, then *parses it back with the
decoder's own classes* (vorbisio._parse_headers) and uses the resulting
Floor1 geometry and Codebook reconstruction vectors for all quantization
decisions — encoder/decoder consistency is by construction, not by
parallel implementation.

All per-frame entropy streams are fixed-length codes (4/7/8-bit flat
Huffman books — canonical assignment makes codeword(e) = e), so packet
assembly vectorizes: each frame becomes a (values, nbits, mask) slot
array packed LSB-first by numpy in one pass.
"""

from __future__ import annotations

import io
import os
import struct
from typing import BinaryIO, List, Union

import numpy as np

from . import vorbisio
from .vorbisio import BitReader, ilog, ogg_crc, vorbis_window

# ---------------------------------------------------------------------------
# Coding setup constants
# ---------------------------------------------------------------------------

_BLOCKSIZE = 2048
_M = _BLOCKSIZE // 2  # 1024 spectral bins / hop
_RANGEBITS = 10
_MULTIPLIER = 2  # floor1 multiplier → y range [0, 128)
_FLOOR_RNG = 128
_FLOOR_BITS = 7  # ilog(rng - 1)
# interior floor posts (x_list = [0, 1024] + partition posts, all unique)
_POSTS_P0 = (4, 8, 16, 24, 32, 48, 64)
_POSTS_P1 = (96, 128, 192, 256, 384, 512, 768)
_N_POSTS = 2 + len(_POSTS_P0) + len(_POSTS_P1)

_PART_SIZE = 32
_N_PARTS = _M // _PART_SIZE  # 32
_CLASSIFICATIONS = 4
_CPC = 2  # classbook dims: classifications coded pairwise
_N_GROUPS = _N_PARTS // _CPC  # 16

# value books: (levels per component, step).  2-dim product books with all
# codewords the same length (2·log2(levels) bits — Kraft exactly 1); a book
# with L levels reaches ±(L−1)/2·step per component.  Only the fine book's
# step varies with the quality knob (the B/C cascade always covers the
# floor-misfit range, and B's quantization error ≤ 0.325 stays inside A's
# reach for every quality setting).
_BOOK_INDEX = {"A": 1, "B": 2, "C": 3}


def _book_specs(quality: float) -> dict:
    if not (0.0 <= quality <= 1.0):
        raise ValueError("vorbis encode: quality must be in [0, 1]")
    delta_a = 0.2 * (0.045 / 0.2) ** quality  # 0.2 (q=0) … 0.045 (q=1)
    return {
        "A": (32, delta_a),  # fine   ±15.5·Δ, 5 bits/coefficient
        "B": (32, 0.65),  # medium  ±10.075
        "C": (16, 14.0),  # coarse  ±105.0
    }


def float32_pack(v: float) -> int:
    """Inverse of vorbisio.float32_unpack (21-bit mantissa, offset-788 exp)."""
    if v == 0.0:
        return 0
    sign = 0x80000000 if v < 0 else 0
    v = abs(v)
    frac, exp = np.frexp(v)  # v = frac * 2**exp, 0.5 <= frac < 1
    mantissa = int(round(frac * (1 << 21)))
    exp = int(exp) - 21 + 788
    if mantissa == 1 << 21:  # rounding overflow
        mantissa >>= 1
        exp += 1
    if not (0 <= exp < 1024):
        raise ValueError(f"float32_pack: exponent out of range for {v}")
    return sign | (exp << 21) | (mantissa & 0x1FFFFF)


# ---------------------------------------------------------------------------
# Bit assembly (LSB-first, per the Vorbis bitpacking convention)
# ---------------------------------------------------------------------------


class BitWriter:
    """LSB-first bit packer for the (small) header packets."""

    def __init__(self):
        self.acc = 0
        self.nbits = 0
        self.out = bytearray()

    def put(self, value: int, nbits: int):
        if nbits == 0:
            return
        self.acc |= (value & ((1 << nbits) - 1)) << self.nbits
        self.nbits += nbits
        while self.nbits >= 8:
            self.out.append(self.acc & 0xFF)
            self.acc >>= 8
            self.nbits -= 8

    def put_codeword(self, code: int, nbits: int):
        """Huffman codewords enter the stream MSB-first."""
        for b in range(nbits - 1, -1, -1):
            self.put((code >> b) & 1, 1)

    def bytes(self) -> bytes:
        out = bytes(self.out)
        if self.nbits:
            out += bytes([self.acc & 0xFF])
        return out


# native C packer (_native/vorbis_core.cc, built at first use); where g++
# cannot build it, the NumPy packer below gives the same bytes
from . import _native_vorbis


def _pack_lsb(values: np.ndarray, nbits: np.ndarray) -> bytes:
    """LSB-first packer: values[i]'s low nbits[i] bits in order."""
    if _native_vorbis.available():
        return _native_vorbis.pack_lsb(values, nbits)
    # numpy fallback: row-major mask selection yields the bit stream already
    # in order, so packing is one np.packbits(..., bitorder="little")
    nbits = np.asarray(nbits, dtype=np.int64)
    if len(nbits) == 0 or int(nbits.max(initial=0)) == 0:
        return b""
    maxb = int(nbits.max())
    bidx = np.arange(maxb, dtype=np.int32)
    bits = ((values.astype(np.int32)[:, None] >> bidx) & 1).astype(np.uint8)
    mask = bidx < nbits[:, None].astype(np.int32)
    flat = bits[mask]
    return np.packbits(flat, bitorder="little").tobytes()


def _bit_reverse_table(nbits: int) -> np.ndarray:
    """rev[e] = e's nbits-bit reversal — flat-book codewords stream-ready."""
    e = np.arange(1 << nbits, dtype=np.int64)
    r = np.zeros_like(e)
    for b in range(nbits):
        r |= ((e >> b) & 1) << (nbits - 1 - b)
    return r


_REV4 = _bit_reverse_table(4)
_REV7 = _bit_reverse_table(7)
_REV = {n: _bit_reverse_table(n) for n in (8, 10)}


# ---------------------------------------------------------------------------
# Header packets
# ---------------------------------------------------------------------------


def _id_packet(channels: int, rate: int) -> bytes:
    bs = int(np.log2(_BLOCKSIZE))
    return (
        b"\x01vorbis"
        + struct.pack("<IBI", 0, channels, rate)
        + struct.pack("<iii", 0, 0, 0)
        + bytes([bs | (bs << 4), 0x01])
    )


def _comment_packet() -> bytes:
    vendor = b"audio-raytracing-studio-tpu native encoder"
    return (
        b"\x03vorbis"
        + struct.pack("<I", len(vendor))
        + vendor
        + struct.pack("<I", 0)
        + b"\x01"
    )


def _write_flat_scalar_book(w: BitWriter, dims: int, entries: int, length: int):
    """Lookup-type-0 codebook, all codewords the same length (Kraft = 1)."""
    w.put(0x564342, 24)
    w.put(dims, 16)
    w.put(entries, 24)
    w.put(0, 1)  # not ordered
    w.put(0, 1)  # not sparse
    for _ in range(entries):
        w.put(length - 1, 5)
    w.put(0, 4)  # lookup type 0


def _write_uniform_vq_book(w: BitWriter, levels: int, delta: float):
    """2-dim lookup-type-1 book: `levels` uniform steps per component,
    centred on zero (min = −(levels−1)/2·delta), all codewords equal length."""
    entries = levels * levels
    length = 2 * int(np.log2(levels))
    vbits = max(1, ilog(levels - 1))
    w.put(0x564342, 24)
    w.put(2, 16)
    w.put(entries, 24)
    w.put(0, 1)
    w.put(0, 1)
    for _ in range(entries):
        w.put(length - 1, 5)
    w.put(1, 4)  # lookup type 1
    w.put(float32_pack(-(levels - 1) / 2.0 * delta), 32)
    w.put(float32_pack(delta), 32)
    w.put(vbits - 1, 4)
    w.put(0, 1)  # sequence_p
    for m in range(levels):
        w.put(m, vbits)


def _setup_packet(specs: dict) -> bytes:
    w = BitWriter()
    for b in b"\x05vorbis":
        w.put(b, 8)
    # --- codebooks: 0 classbook, 1 fine(A), 2 medium(B), 3 coarse(C), 4 floor
    w.put(5 - 1, 8)
    _write_flat_scalar_book(w, dims=_CPC, entries=16, length=4)  # 0
    _write_uniform_vq_book(w, *specs["A"])  # 1
    _write_uniform_vq_book(w, *specs["B"])  # 2
    _write_uniform_vq_book(w, *specs["C"])  # 3
    _write_flat_scalar_book(w, dims=1, entries=_FLOOR_RNG, length=_FLOOR_BITS)  # 4
    # --- time transforms
    w.put(0, 6)
    w.put(0, 16)
    # --- floors: one floor1
    w.put(0, 6)
    w.put(1, 16)  # floor type 1
    w.put(2, 5)  # partitions
    w.put(0, 4)  # partition 0 → class 0
    w.put(0, 4)  # partition 1 → class 0
    w.put(len(_POSTS_P0) - 1, 3)  # class 0 dim − 1 (7 posts per partition)
    w.put(0, 2)  # subclasses = 0 → no masterbook
    w.put(4 + 1, 8)  # subclass book: floor book index + 1
    w.put(_MULTIPLIER - 1, 2)
    w.put(_RANGEBITS, 4)
    for x in _POSTS_P0 + _POSTS_P1:
        w.put(x, _RANGEBITS)
    # --- residues: one type-1 residue
    w.put(0, 6)
    w.put(1, 16)  # residue type 1
    w.put(0, 24)  # begin
    w.put(_M, 24)  # end
    w.put(_PART_SIZE - 1, 24)
    w.put(_CLASSIFICATIONS - 1, 6)
    w.put(0, 8)  # classbook
    for cascade in (0b000, 0b001, 0b011, 0b111):  # classes 0..3 pass bitmaps
        w.put(cascade, 3)
        w.put(0, 1)  # no high bits
    # books per (class, pass) for set cascade bits, pass-major per class:
    # class 1: pass0 → A;  class 2: pass0 B, pass1 A;  class 3: C, B, A
    for books in ((1,), (2, 1), (3, 2, 1)):
        for b in books:
            w.put(b, 8)
    # --- mappings: one type-0, 1 submap, no coupling
    w.put(0, 6)
    w.put(0, 16)  # mapping type 0
    w.put(0, 1)  # submaps flag → 1 submap
    w.put(0, 1)  # coupling flag
    w.put(0, 2)  # reserved
    w.put(0, 8)  # time config (unused)
    w.put(0, 8)  # floor 0
    w.put(0, 8)  # residue 0
    # --- modes: one, blockflag 0
    w.put(0, 6)
    w.put(0, 1)  # blockflag
    w.put(0, 16)
    w.put(0, 16)
    w.put(0, 8)  # mapping 0
    w.put(1, 1)  # framing
    return w.bytes()


# ---------------------------------------------------------------------------
# Analysis: MDCT, floor fitting, residue quantization
# ---------------------------------------------------------------------------


def _mdct_frames(xp: np.ndarray, n_frames: int) -> np.ndarray:
    """Forward MDCT of all frames: xp (ch, padded) → (F, ch, M).

    Folds each windowed frame to length M and applies DCT-IV/M — the exact
    adjoint of vorbisio.imdct (scale pinned by the round-trip test)."""
    from scipy.fft import dct

    ch = xp.shape[0]
    n, m, half = _BLOCKSIZE, _M, _M // 2
    idx = np.arange(n_frames)[:, None] * m + np.arange(n)[None, :]
    frames = xp[:, idx] * vorbis_window(n)  # (ch, F, n)
    f = np.empty((ch, n_frames, m))
    j = np.arange(half, m)
    f[:, :, half:] = frames[:, :, j - half] - frames[:, :, half + m - 1 - j]
    j = np.arange(half)
    f[:, :, :half] = -frames[:, :, half + m + j] - frames[:, :, half + m - 1 - j]
    spec = dct(f, type=4, axis=-1) / m
    return np.ascontiguousarray(np.swapaxes(spec, 0, 1))  # (F, ch, M)


_X_LIST = np.array((0, 1 << _RANGEBITS) + _POSTS_P0 + _POSTS_P1, dtype=np.int64)
# fitting windows: post i's target is the max |spec| over the bin span
# reaching halfway to each X-neighbour (clipped to the valid bin range)
_SORTED = np.argsort(_X_LIST)


def _post_windows() -> List[tuple]:
    xs = _X_LIST[_SORTED]
    spans = []
    for k, x in enumerate(xs):
        lo = 0 if k == 0 else (xs[k - 1] + x) // 2
        hi = _M if k == len(xs) - 1 else (x + xs[k + 1]) // 2 + 1
        spans.append((int(max(lo, 0)), int(min(max(hi, lo + 1), _M))))
    return spans


_POST_SPANS = _post_windows()
_LOG_IDB = np.log(1.0649863)
_IDB_0 = 1.0649863e-07


def _fit_floor_y(spec_abs: np.ndarray) -> np.ndarray:
    """(F, ch, M) |spectrum| → per-post floor values (F, ch, posts) in raw
    x_list order, integer [0, 127]."""
    F, ch, _ = spec_abs.shape
    y_sorted = np.empty((F, ch, _N_POSTS))
    logs = np.log(np.maximum(spec_abs, 1e-30))
    for k, (lo, hi) in enumerate(_POST_SPANS):
        # fit in the log domain at a high quantile: tracking the local mean
        # (not the max) puts quantization noise under the local energy, and
        # the B/C residue classes absorb the peaks above the floor
        y_sorted[:, :, k] = np.quantile(logs[:, :, lo:hi], 0.85, axis=-1)
    # amplitude → dB-table index: _INVERSE_DB[v] = IDB_0 · 1.0649863^v
    v = (y_sorted - np.log(_IDB_0)) / _LOG_IDB
    units = np.ceil(v / _MULTIPLIER)  # round UP: floor ≥ fit point
    units = np.clip(units, 0, _FLOOR_RNG - 1).astype(np.int64)
    y_raw = np.empty_like(units)
    y_raw[:, :, _SORTED] = units
    return y_raw


def _render_point_vec(x0, y0, x1, y1, x):
    """Vectorized spec render_point (validated == the decoder's Bresenham)."""
    dy = y1 - y0
    off = (np.abs(dy) * (x - x0)) // (x1 - x0)
    return np.where(dy < 0, y0 - off, y0 + off)


def _encode_floor_posts(y: np.ndarray, setup):
    """Encode post values (F, ch, posts) → (final_y, vals) both (F, ch, posts).

    vals[..., 2:] are the entropy-coded prediction residuals; val = 0 is
    never produced (a zero would clear the decoder's step-2 flag and change
    the curve's segment structure) — when the desired value sits exactly on
    the predicted line it is nudged by one floor unit (~1.09 dB).
    """
    fl = setup.floors[0]
    final = np.empty_like(y)
    vals = np.zeros_like(y)
    final[:, :, 0] = y[:, :, 0]
    final[:, :, 1] = y[:, :, 1]
    rng = _FLOOR_RNG
    for i in range(2, _N_POSTS):
        lo, hi = fl.lo_nb[i - 2], fl.hi_nb[i - 2]
        pred = _render_point_vec(
            _X_LIST[lo], final[:, :, lo], _X_LIST[hi], final[:, :, hi], _X_LIST[i]
        )
        desired = y[:, :, i]
        # avoid val == 0: nudge on-line values one unit up (or down at the rail)
        desired = np.where(
            desired == pred, np.where(pred + 1 < rng, pred + 1, pred - 1), desired
        )
        diff = desired - pred
        highroom = rng - pred
        lowroom = pred
        room = 2 * np.minimum(highroom, lowroom)
        d = np.abs(diff)
        # parity form: even val → pred + val/2, odd → pred − (val+1)/2;
        # usable whenever the resulting val stays < room (decoder branch)
        val_small = np.where(diff > 0, 2 * d, 2 * d - 1)
        small = val_small < room
        val_big = np.where(highroom > lowroom, diff + lowroom, highroom + d - 1)
        vals[:, :, i] = np.where(small, val_small, val_big)
        final[:, :, i] = desired
    return final, vals


def _floor_curves(final_y: np.ndarray) -> np.ndarray:
    """Render decoder-exact floor curves (F, ch, M) from final post values.

    All posts always render (vals never 0 → step-2 all true), so the
    segment structure is static and each segment vectorizes over frames."""
    F, ch, _ = final_y.shape
    v = np.empty((F, ch, _M), dtype=np.int64)
    xs = _X_LIST[_SORTED]
    ys = final_y[:, :, _SORTED] * _MULTIPLIER
    for k in range(len(xs) - 1):
        x0, x1 = int(xs[k]), int(xs[k + 1])
        if x0 >= _M:
            break
        hi = min(x1, _M)
        xr = np.arange(x0, hi, dtype=np.int64)
        seg = _render_point_vec(
            x0, ys[:, :, k, None], x1, ys[:, :, k + 1, None], xr
        )
        v[:, :, x0:hi] = seg
    np.clip(v, 0, 255, out=v)
    return vorbisio._INVERSE_DB[v]


_SETUP_CACHE: dict = {}


def _own_setup(specs: dict):
    """The encoder's setup parsed through the DECODER's classes (consistency
    by construction: floor geometry + codebook vectors come from the same
    bytes the decoder will read)."""
    key = specs["A"][1]
    if key not in _SETUP_CACHE:
        packets = [
            (_id_packet(2, 48000), -1),
            (_comment_packet(), -1),
            (_setup_packet(specs), -1),
        ]
        s, _ = vorbisio._parse_headers(packets)
        _SETUP_CACHE[key] = s
    return _SETUP_CACHE[key]


def _quantize_residue(res: np.ndarray, specs: dict, setup):
    """(F, ch, M) residue → (classes (F, ch, parts), mults per book pass).

    Classes: 0 silent, 1 → A, 2 → B+A, 3 → C+B+A.  Quantization is the
    greedy cascade the decoder sums back up, using the parsed codebook
    reconstruction vectors."""
    s = setup
    # per-component reconstruction grids from the PARSED codebooks (the
    # exact values the decoder will add back)
    grids = {}
    for key, (levels, _) in specs.items():
        lv = s.codebooks[_BOOK_INDEX[key]].vectors[:levels, 0]
        grids[key] = (levels, float(lv[1] - lv[0]), float(lv[0]))
    F, ch, _ = res.shape
    pmax = np.abs(res.reshape(F, ch, _N_PARTS, _PART_SIZE)).max(axis=-1)

    def reach(key):
        levels, delta, mn = grids[key]
        return -mn  # symmetric grid: max reach per component

    classes = np.full((F, ch, _N_PARTS), 3, dtype=np.int64)
    classes[pmax <= reach("B") + reach("A")] = 2
    classes[pmax <= reach("A")] = 1
    classes[pmax < 0.5 * grids["A"][1]] = 0
    # cascade quantization: book applies to class >= (3, 2, 1)
    rem = res.copy()
    mults = {}
    pclass = np.repeat(classes, _PART_SIZE, axis=-1)  # (F, ch, M)
    for key, cls_min in (("C", 3), ("B", 2), ("A", 1)):
        levels, delta, mn = grids[key]
        m = np.clip(np.round((rem - mn) / delta), 0, levels - 1).astype(np.int64)
        use = pclass >= cls_min
        m = np.where(use, m, 0)
        rem = rem - np.where(use, m * delta + mn, 0.0)
        mults[key] = m
    return classes, mults


# ---------------------------------------------------------------------------
# Packet assembly
# ---------------------------------------------------------------------------


def _audio_packets(spec: np.ndarray, specs: dict) -> List[bytes]:
    """Encode all frames → list of audio packet byte strings."""
    setup = _own_setup(specs)
    F, ch, _ = spec.shape
    spec_abs = np.abs(spec)
    y = _fit_floor_y(spec_abs)
    final_y, vals = _encode_floor_posts(y, setup)
    curves = _floor_curves(final_y)
    res = spec / curves
    classes, mults = _quantize_residue(res, specs, setup)

    # --- fixed-structure slot arrays ------------------------------------
    # floor block per channel: nonzero(1) y0(7) y1(7) + 14 coded vals (7)
    floor_vals = np.empty((F, ch, 3 + (_N_POSTS - 2)), dtype=np.int64)
    floor_vals[:, :, 0] = 1
    floor_vals[:, :, 1] = final_y[:, :, 0]
    floor_vals[:, :, 2] = final_y[:, :, 1]
    floor_vals[:, :, 3:] = _REV7[vals[:, :, 2:]]
    floor_bits = np.full((ch, 3 + (_N_POSTS - 2)), _FLOOR_BITS, dtype=np.int64)
    floor_bits[:, 0] = 1

    # classwords: pairs of partition classes → 4-bit flat codewords
    cw = classes[:, :, 0::2] * _CLASSIFICATIONS + classes[:, :, 1::2]
    cw = _REV4[cw]  # (F, ch, groups)

    # partition entries per book: pair mults → flat codewords (stream order)
    def entries(book):
        levels, _ = specs[book]
        cbits = 2 * int(np.log2(levels))
        m = mults[book].reshape(F, ch, _N_PARTS, _PART_SIZE)
        return _REV[cbits][m[..., 0::2] + levels * m[..., 1::2]]  # (F,ch,parts,16)

    ent = {b: entries(b) for b in ("C", "B", "A")}
    book_bits = {b: 2 * int(np.log2(specs[b][0])) for b in ("C", "B", "A")}
    epp = _PART_SIZE // 2  # entries per partition
    G = _N_GROUPS
    cls4 = classes[..., None]  # (F, ch, parts, 1) for broadcasting

    def _entry_slots(val, bits, mask):
        """(F, ch, parts, epp) arrays → decoder slot order
        (F, groups, i, ch, epp) flattened to (F, G·cpc·ch·epp)."""

        def rearrange(x):
            x = x.reshape(F, ch, G, _CPC, epp)
            return np.transpose(x, (0, 2, 3, 1, 4)).reshape(F, -1)

        return rearrange(val), rearrange(bits), rearrange(mask)

    # pass p emits book (by class): class 1:[A], 2:[B,A], 3:[C,B,A]
    passes = []
    # pass 0: A for class 1, B for class 2, C for class 3
    v0 = np.where(cls4 == 1, ent["A"], np.where(cls4 == 2, ent["B"], ent["C"]))
    b0 = np.broadcast_to(
        np.where(
            cls4 == 1,
            book_bits["A"],
            np.where(cls4 == 2, book_bits["B"], book_bits["C"]),
        ),
        v0.shape,
    )
    m0 = np.broadcast_to(cls4 >= 1, v0.shape)
    passes.append(_entry_slots(v0, b0, m0))
    # pass 1: A for class 2, B for class 3
    v1 = np.where(cls4 == 2, ent["A"], ent["B"])
    b1 = np.broadcast_to(
        np.where(cls4 == 2, book_bits["A"], book_bits["B"]), v1.shape
    )
    m1 = np.broadcast_to(cls4 >= 2, v1.shape)
    passes.append(_entry_slots(v1, b1, m1))
    # pass 2: A for class 3
    m2 = np.broadcast_to(cls4 == 3, v1.shape)
    passes.append(
        _entry_slots(ent["A"], np.full(v1.shape, book_bits["A"], np.int64), m2)
    )

    # classword slots lead each pass-0 group: (F, groups, ch)
    cw_slots = np.transpose(cw, (0, 2, 1)).reshape(F, -1)

    # Assemble the per-frame slot matrix in decoder emission order
    # (_decode_core): header bit, per-channel floor, then pass-major groups
    # — pass 0 interleaves classwords with its cpc-partition blocks.
    def _interleave_pass0(cw_v, p0_v):
        """(F, G·ch) classwords + (F, G·cpc·ch·epp) entries → grouped."""
        block = _CPC * ch * epp
        cw3 = cw_v.reshape(F, G, ch)
        p03 = p0_v.reshape(F, G, block)
        return np.concatenate([cw3, p03], axis=2).reshape(F, -1)

    vals_list = [
        np.zeros((F, 1), np.int64),  # audio-packet type bit
        floor_vals.reshape(F, -1),
        _interleave_pass0(cw_slots, passes[0][0]),
        passes[1][0].astype(np.int64),
        passes[2][0].astype(np.int64),
    ]
    bits_list = [
        np.ones((F, 1), np.int64),
        np.broadcast_to(floor_bits.reshape(-1), (F, floor_bits.size)),
        _interleave_pass0(np.full((F, G * ch), 4, np.int64), passes[0][1]),
        passes[1][1],
        passes[2][1],
    ]
    mask_list = [
        np.ones((F, 1), bool),
        np.ones((F, floor_bits.size), bool),
        _interleave_pass0(np.ones((F, G * ch), bool), passes[0][2]),
        passes[1][2],
        passes[2][2],
    ]
    all_vals = np.concatenate(vals_list, axis=1)
    all_bits = np.concatenate(bits_list, axis=1)
    all_mask = np.concatenate(mask_list, axis=1)
    all_bits = np.where(all_mask, all_bits, 0)

    # byte-align each packet with a zero pad slot, pack the whole chunk in
    # one ordered-bit pass, then split at the per-frame byte offsets
    frame_bits = all_bits.sum(axis=1)
    pad = (-frame_bits) % 8
    all_vals = np.concatenate([all_vals, np.zeros((F, 1), np.int64)], axis=1)
    all_bits = np.concatenate([all_bits, pad[:, None]], axis=1)
    blob = _pack_lsb(all_vals.reshape(-1), all_bits.reshape(-1))
    nbytes = (frame_bits + pad) // 8
    offs = np.zeros(F + 1, dtype=np.int64)
    np.cumsum(nbytes, out=offs[1:])
    return [blob[offs[f] : offs[f + 1]] for f in range(F)]


# ---------------------------------------------------------------------------
# Ogg encapsulation
# ---------------------------------------------------------------------------


def _ogg_page(
    header_type: int, granule: int, serial: int, seq: int, packets: List[bytes]
) -> bytes:
    laces = bytearray()
    body = bytearray()
    for p in packets:
        l = len(p)
        while l >= 255:
            laces.append(255)
            l -= 255
        laces.append(l)
        body += p
    if len(laces) > 255:
        raise ValueError("Ogg page overflow (too many segments)")
    head = (
        b"OggS\x00"
        + bytes([header_type])
        + struct.pack("<q", granule)
        + struct.pack("<II", serial, seq)
        + b"\x00\x00\x00\x00"
        + bytes([len(laces)])
        + bytes(laces)
    )
    page = bytearray(head + bytes(body))
    crc = ogg_crc(bytes(page))
    page[22:26] = struct.pack("<I", crc)
    return bytes(page)


def encode(
    data: np.ndarray,
    rate: int,
    path_or_file: Union[str, os.PathLike, BinaryIO],
    quality: float = 0.5,
) -> None:
    """Encode float PCM → Ogg/Vorbis.

    data: (samples,) or (samples, channels) float; values nominally in
    [−1, 1] (hotter signals encode fine — Vorbis is float end to end).
    quality ∈ [0, 1] scales the fine quantizer step (0 ≈ smallest files,
    1 ≈ highest fidelity; default 0.5 measures ~SNR 33 dB on broadband
    test content).
    """
    x = np.asarray(data, dtype=np.float32)
    if x.ndim == 1:
        x = x[:, None]
    if x.ndim != 2 or x.shape[0] == 0:
        raise ValueError("vorbis encode: expected (samples,) or (samples, ch)")
    if not (1 <= x.shape[1] <= 8):
        raise ValueError(f"vorbis encode: unsupported channel count {x.shape[1]}")
    if rate <= 0:
        raise ValueError("vorbis encode: rate must be positive")
    if not np.all(np.isfinite(x)):
        # a single NaN/Inf sample propagates through the MDCT into the
        # floor quantizer, where the int64 cast of NaN becomes INT64_MIN
        # and indexes out of bounds (found by tools/fuzz_campaign.py) —
        # reject with the clean-ValueError error contract instead
        raise ValueError("vorbis encode: non-finite samples (NaN/Inf)")
    T, ch = x.shape
    # input columns are in WAV order (FL FR C LFE …, config.CHANNEL_LAYOUTS);
    # the Vorbis I spec (§4.3.9) fixes its own multichannel order, so permute
    # before coding — vorbisio.decode applies the inverse, and real-world
    # decoders (libvorbis, ffmpeg) now read repo files channel-correct
    from .vorbisio import VORBIS_FROM_WAV

    perm = VORBIS_FROM_WAV.get(ch)
    if perm is not None:
        x = x[:, list(perm)]
    xc = np.ascontiguousarray(x.T)  # (ch, T)

    n_frames = -(-T // _M) + 1
    padded = (n_frames - 1) * _M + _BLOCKSIZE
    xp = np.zeros((ch, padded), dtype=np.float32)
    xp[:, _M : _M + T] = xc

    # chunk over frames to bound memory (each frame = one packet; frames
    # only couple through xp's 50% overlap, handled by indexing into xp)
    specs = _book_specs(quality)
    packets: List[bytes] = []
    chunk = 1024
    for f0 in range(0, n_frames, chunk):
        fn = min(chunk, n_frames - f0)
        spec = _mdct_frames(xp[:, f0 * _M :], fn)
        packets.extend(_audio_packets(spec.astype(np.float32), specs))

    out = io.BytesIO()
    serial = 0x52545541  # "AUTR"
    seq = 0
    out.write(_ogg_page(0x02, 0, serial, seq, [_id_packet(ch, rate)]))
    seq += 1
    out.write(
        _ogg_page(0, 0, serial, seq, [_comment_packet(), _setup_packet(specs)])
    )
    seq += 1

    # audio pages: a few packets per page; granule = decodable sample count
    i = 0
    while i < len(packets):
        group: List[bytes] = []
        lace_budget = 255
        while i < len(packets) and lace_budget >= (len(packets[i]) // 255 + 1):
            group.append(packets[i])
            lace_budget -= len(packets[i]) // 255 + 1
            i += 1
            if sum(map(len, group)) > 16384:
                break
        if not group:
            raise ValueError("Ogg page overflow: packet exceeds one page")
        last = i == len(packets)
        granule = min(i - 1, n_frames - 1) * _M
        if last:
            granule = T
        out.write(_ogg_page(0x04 if last else 0, granule, serial, seq, group))
        seq += 1

    blob = out.getvalue()
    if hasattr(path_or_file, "write"):
        path_or_file.write(blob)
    else:
        with open(path_or_file, "wb") as fh:
            fh.write(blob)


def write(
    path: Union[str, os.PathLike],
    data: np.ndarray,
    rate: int,
    quality: float = 0.5,
) -> None:
    """File-writing convenience mirroring flacio.write's signature."""
    encode(data, rate, path, quality=quality)


def quality_for_bitrate(bitrate_kbps: int) -> float:
    """Map a nominal bitrate request (the analyzer CLI/UI contract, mirroring
    the reference's pydub ``bitrate=`` export arg) onto the encoder's
    quality knob.  The encoder is quality-mode only (like libvorbis -q);
    anchor points measured on broadband stereo 44.1 kHz content:
    q0 ≈ 90 kbps, q0.5 ≈ 160 kbps, q1 ≈ 260 kbps."""
    return float(np.clip((float(bitrate_kbps) - 90.0) / 170.0, 0.0, 1.0))
