"""Ogg/Vorbis decoder — the port's own copy of ``audio_raytracing_studio_tpu/
utils/vorbisio.py`` (host code, no device work).

The reference studio reads .ogg uploads through libsndfile (its
raytracer_studio.py:1013).  This decoder needs neither libsndfile nor
ffmpeg, the same posture as the FLAC codec (utils/flacio.py): Python +
NumPy with the optional C++ hot loops of ``_native/vorbis_core.cc`` (built
at first use), spec-complete for the streams real
encoders produce (floor type 1, residue types 0/1/2, all window
transitions), with integrity checks (Ogg page CRC-32) and clean errors on
truncation/corruption.

Decode pipeline (Vorbis I specification):

  Ogg pages (CRC-checked) → packets → [id, comment, setup] headers →
  codebooks (canonical-huffman + VQ lookup) → per audio packet: mode →
  floor1 posts (integer Bresenham curve in dB units) → residue partitions
  (VQ vector adds) → inverse channel coupling (square polar) →
  floor × residue → IMDCT (via scipy DCT-IV) → Vorbis window →
  overlap-add with spec left/right slope geometry → granule trim.

Not implemented: floor type 0 (LSP; deprecated — no mainstream encoder has
emitted it since libvorbis 1.0 beta) — raises a clear ValueError.

Interop: the JAX package's suite cross-validates this decoder against
SDL_mixer's independent one on a real libvorbis-encoded stream; the port's
tests hold this copy to the JAX package's sample for sample.
"""

from __future__ import annotations

import os
import struct
from typing import BinaryIO, Dict, List, Optional, Tuple, Union

import numpy as np


class UnsupportedCodec(ValueError):
    """The Ogg container is legal but the payload is not native-decodable
    Vorbis (Opus, Ogg/FLAC, Speex, floor-0 Vorbis, …) — callers should fall
    through to a universal decode tier rather than report corruption."""


# ---------------------------------------------------------------------------
# Ogg container layer
# ---------------------------------------------------------------------------

# native hot loops (_native/vorbis_core.cc, built at first use); where g++
# cannot build them, _native.available() is False and the NumPy paths run
from . import _native_vorbis as _native

_CRC_TABLE = None


def _ogg_crc_table() -> np.ndarray:
    """CRC-32 table, poly 0x04C11DB7, non-reflected (Ogg flavor)."""
    global _CRC_TABLE
    if _CRC_TABLE is None:
        tab = np.zeros(256, dtype=np.uint32)
        for i in range(256):
            r = i << 24
            for _ in range(8):
                if r & 0x80000000:
                    r = ((r << 1) ^ 0x04C11DB7) & 0xFFFFFFFF
                else:
                    r = (r << 1) & 0xFFFFFFFF
            tab[i] = r
        _CRC_TABLE = tab
    return _CRC_TABLE


def ogg_crc(data: bytes) -> int:
    if _native.available():
        return _native.ogg_crc(data)
    tab = _ogg_crc_table()
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ int(tab[((crc >> 24) & 0xFF) ^ b])
    return crc


class OggPage:
    __slots__ = ("header_type", "granule", "serial", "seq", "segments", "body")

    def __init__(self, header_type, granule, serial, seq, segments, body):
        self.header_type = header_type
        self.granule = granule
        self.serial = serial
        self.seq = seq
        self.segments = segments
        self.body = body


def _read_page(data: bytes, off: int) -> Tuple[OggPage, int]:
    """Parse one Ogg page at ``off`` (must start with OggS) → (page, next)."""
    if data[off : off + 4] != b"OggS":
        raise ValueError("Ogg capture pattern missing (corrupt stream)")
    if off + 27 > len(data):
        raise ValueError("truncated Ogg page header")
    version = data[off + 4]
    if version != 0:
        raise ValueError(f"unsupported Ogg version {version}")
    header_type = data[off + 5]
    granule = struct.unpack_from("<q", data, off + 6)[0]
    serial = struct.unpack_from("<I", data, off + 14)[0]
    seq = struct.unpack_from("<I", data, off + 18)[0]
    crc = struct.unpack_from("<I", data, off + 22)[0]
    nsegs = data[off + 26]
    seg_end = off + 27 + nsegs
    if seg_end > len(data):
        raise ValueError("truncated Ogg segment table")
    segments = list(data[off + 27 : seg_end])
    body_len = sum(segments)
    body_end = seg_end + body_len
    if body_end > len(data):
        raise ValueError("truncated Ogg page body")
    page_bytes = bytearray(data[off:body_end])
    page_bytes[22:26] = b"\x00\x00\x00\x00"
    if ogg_crc(bytes(page_bytes)) != crc:
        raise ValueError(f"Ogg page CRC mismatch (page seq {seq})")
    body = data[seg_end:body_end]
    return OggPage(header_type, granule, serial, seq, segments, body), body_end


def _ogg_packets(data: bytes):
    """Yield (packet_bytes, page_granule_at_completion) for the first Vorbis
    logical stream.  Granule is the granule of the page on which the packet
    COMPLETES (−1 when the page carries none)."""
    off = 0
    serial = None
    partial = b""
    final_granule = -1
    packets: List[Tuple[bytes, int]] = []
    while off < len(data):
        nxt = data.find(b"OggS", off)
        if nxt < 0:
            break
        page, off = _read_page(data, nxt)
        if serial is None:
            if not (page.header_type & 0x02):
                raise ValueError("Ogg stream does not start with a BOS page")
            serial = page.serial
        if page.serial != serial:
            continue  # multiplexed secondary stream — skip
        if not (page.header_type & 0x01) and partial:
            # new page does not continue the pending packet — drop the
            # orphan (stream truncated mid-packet at a page boundary)
            partial = b""
        pos = 0
        for i, seg in enumerate(page.segments):
            partial += page.body[pos : pos + seg]
            pos += seg
            if seg < 255:
                gran = page.granule if i == len(page.segments) - 1 else -1
                packets.append((partial, gran))
                partial = b""
        if page.granule >= 0:
            final_granule = page.granule
        if page.header_type & 0x04:  # EOS
            break
    if not packets:
        raise ValueError("Ogg stream contains no complete packets")
    return packets, final_granule


# ---------------------------------------------------------------------------
# LSB-first bit reader (Vorbis packing convention — opposite of FLAC)
# ---------------------------------------------------------------------------


class BitReader:
    """LSB-first reader over one packet with a 64-bit refill accumulator."""

    __slots__ = ("data", "pos", "acc", "nbits", "length")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # next byte to load
        self.acc = 0
        self.nbits = 0
        self.length = len(data) * 8

    def _refill(self, need: int):
        while self.nbits < need:
            if self.pos >= len(self.data):
                raise EOFError("Vorbis packet exhausted")
            self.acc |= self.data[self.pos] << self.nbits
            self.pos += 1
            self.nbits += 8

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self._refill(n)
        val = self.acc & ((1 << n) - 1)
        self.acc >>= n
        self.nbits -= n
        return val

    def read_bit(self) -> int:
        self._refill(1)
        val = self.acc & 1
        self.acc >>= 1
        self.nbits -= 1
        return val

    def bits_consumed(self) -> int:
        return self.pos * 8 - self.nbits

    def seek_bits(self, bitpos: int):
        """Reposition to an absolute bit offset (native-decode resync)."""
        self.pos = bitpos >> 3
        rem = bitpos & 7
        if rem:
            self.acc = self.data[self.pos] >> rem
            self.nbits = 8 - rem
            self.pos += 1
        else:
            self.acc = 0
            self.nbits = 0

    def eof_ok(self) -> bool:
        """End-of-packet is a graceful frame end in Vorbis audio decode."""
        return self.bits_consumed() >= self.length


def ilog(x: int) -> int:
    """Vorbis ilog: position of the highest set bit (ilog(0) = 0)."""
    if x <= 0:
        return 0
    return x.bit_length()


def float32_unpack(x: int) -> float:
    """The Vorbis 32-bit packed float (21-bit mantissa, offset-788 exp)."""
    mantissa = x & 0x1FFFFF
    sign = x & 0x80000000
    exp = (x & 0x7FE00000) >> 21
    if sign:
        mantissa = -mantissa
    return float(mantissa) * (2.0 ** (exp - 788))


def lookup1_values(entries: int, dims: int) -> int:
    """Largest v with v**dims <= entries (spec section 3.2)."""
    v = int(entries ** (1.0 / dims))
    while (v + 1) ** dims <= entries:
        v += 1
    while v > 0 and v**dims > entries:
        v -= 1
    return v


# ---------------------------------------------------------------------------
# Codebooks
# ---------------------------------------------------------------------------

_FAST_BITS = 10


def _assign_codewords(lengths: List[int]) -> List[Optional[int]]:
    """Canonical Vorbis codeword assignment (spec 3.2.1): each used entry,
    in order, takes the numerically smallest MSB-first code of its length
    that keeps the code prefix-free.  Implemented with a sorted free-subtree
    list: assigning consumes the smallest free root, splitting off right
    children on the way down."""
    import heapq

    codes: List[Optional[int]] = [None] * len(lengths)
    free: List[Tuple[float, int, int]] = [(0.0, 0, 0)]  # (value in [0,1), code, len)
    for i, l in enumerate(lengths):
        if l <= 0:
            continue
        # numerically smallest free root with len <= l (roots deeper than l
        # cannot host a length-l codeword; stash and restore them)
        stash = []
        found = None
        while free:
            item = heapq.heappop(free)
            if item[2] <= l:
                found = item
                break
            stash.append(item)
        for item in stash:
            heapq.heappush(free, item)
        if found is None:
            raise ValueError("Vorbis codebook is over-specified")
        _, code, cl = found
        while cl < l:
            right = (code << 1) | 1
            heapq.heappush(free, (right / (1 << (cl + 1)), right, cl + 1))
            code <<= 1
            cl += 1
        codes[i] = code
    return codes


class Codebook:
    """One parsed codebook: huffman decode (+ fast table) and VQ lookup."""

    def __init__(self, r: BitReader):
        if r.read(24) != 0x564342:
            raise ValueError("Vorbis codebook sync lost")
        self.dims = r.read(16)
        self.entries = r.read(24)
        ordered = r.read_bit()
        lengths = [0] * self.entries
        if not ordered:
            sparse = r.read_bit()
            for i in range(self.entries):
                if sparse:
                    if r.read_bit():
                        lengths[i] = r.read(5) + 1
                else:
                    lengths[i] = r.read(5) + 1
        else:
            cur_len = r.read(5) + 1
            i = 0
            while i < self.entries:
                num = r.read(ilog(self.entries - i))
                if i + num > self.entries:
                    raise ValueError("Vorbis codebook ordered-length overflow")
                for j in range(i, i + num):
                    lengths[j] = cur_len
                i += num
                cur_len += 1
                if cur_len > 32:
                    break
        self.lengths = lengths
        codes = _assign_codewords(lengths)
        # slow path: {(len << 32) | code: entry}; fast path: stream-order
        # prefix table over _FAST_BITS bits (index bit 0 = first stream bit)
        self.tree: Dict[int, int] = {}
        fast = np.full(1 << _FAST_BITS, -1, dtype=np.int64)
        for e, (l, c) in enumerate(zip(lengths, codes)):
            if c is None:
                continue
            self.tree[(l << 32) | c] = e
            if l <= _FAST_BITS:
                rev = 0
                for b in range(l):  # MSB-first code → stream-order bits
                    rev |= ((c >> (l - 1 - b)) & 1) << b
                step = 1 << l
                packed = (e << 6) | l
                for fill in range(rev, 1 << _FAST_BITS, step):
                    fast[fill] = packed
        self.fast = fast
        self.max_len = max((l for l in lengths if l > 0), default=0)
        self._native_handle = None  # lazy ctypes pointers (_native_vorbis)

        # VQ lookup table
        self.lookup_type = r.read(4)
        self.vectors: Optional[np.ndarray] = None
        if self.lookup_type == 0:
            return
        if self.lookup_type not in (1, 2):
            raise ValueError(f"reserved codebook lookup type {self.lookup_type}")
        min_v = float32_unpack(r.read(32))
        delta = float32_unpack(r.read(32))
        value_bits = r.read(4) + 1
        sequence_p = r.read_bit()
        if self.lookup_type == 1:
            n_mult = lookup1_values(self.entries, self.dims)
            count = n_mult
        else:
            count = self.entries * self.dims
        mults = np.array([r.read(value_bits) for _ in range(count)], dtype=np.float64)
        vecs = np.zeros((self.entries, self.dims), dtype=np.float64)
        if self.lookup_type == 1:
            for e in range(self.entries):
                last = 0.0
                idx_div = 1
                for j in range(self.dims):
                    off = (e // idx_div) % n_mult
                    vecs[e, j] = mults[off] * delta + min_v + last
                    if sequence_p:
                        last = vecs[e, j]
                    idx_div *= n_mult
        else:
            for e in range(self.entries):
                last = 0.0
                for j in range(self.dims):
                    vecs[e, j] = mults[e * self.dims + j] * delta + min_v + last
                    if sequence_p:
                        last = vecs[e, j]
        self.vectors = vecs.astype(np.float32)

    # --- decode ---
    def decode(self, r: BitReader) -> int:
        """One scalar entry via huffman (fast table, slow-tree fallback)."""
        # fast path: peek up to _FAST_BITS stream bits without consuming
        try:
            r._refill(min(_FAST_BITS, self.max_len))
        except EOFError:
            pass
        avail = r.nbits
        idx = r.acc & ((1 << _FAST_BITS) - 1)
        hit = self.fast[idx] if avail >= _FAST_BITS else -1
        if hit >= 0:
            l = int(hit) & 63
            r.acc >>= l
            r.nbits -= l
            return int(hit) >> 6
        # slow path: bit-by-bit MSB-first code build
        code = 0
        length = 0
        tree = self.tree
        while length < 33:
            code = (code << 1) | r.read_bit()
            length += 1
            e = tree.get((length << 32) | code)
            if e is not None:
                return e
        raise ValueError("invalid Vorbis huffman code")

    def decode_vq(self, r: BitReader) -> np.ndarray:
        if self.vectors is None:
            raise ValueError("scalar codebook used in VQ context")
        return self.vectors[self.decode(r)]


# ---------------------------------------------------------------------------
# Floor type 1
# ---------------------------------------------------------------------------

_FLOOR1_RANGES = (256, 128, 86, 64)
# inverse dB table: 256 geometric steps, ~140 dB range (spec section 10)
_INVERSE_DB = (1.0649863e-07 * np.power(1.0649863, np.arange(256))).astype(
    np.float32
)


def _render_point(x0: int, y0: int, x1: int, y1: int, x: int) -> int:
    dy = y1 - y0
    adx = x1 - x0
    ady = abs(dy)
    err = ady * (x - x0)
    off = err // adx
    return y0 - off if dy < 0 else y0 + off


def _render_line(x0: int, y0: int, x1: int, y1: int, v: np.ndarray, n: int):
    """Integer Bresenham from the spec (division truncates toward zero)."""
    dy = y1 - y0
    adx = x1 - x0
    base = int(dy / adx)  # trunc toward zero, NOT floor
    ady = abs(dy) - abs(base) * adx
    sy = base - 1 if dy < 0 else base + 1
    x = x0
    y = y0
    err = 0
    if x0 < n:
        v[x0] = y0
    for x in range(x0 + 1, min(x1, n)):
        err += ady
        if err >= adx:
            err -= adx
            y += sy
        else:
            y += base
        v[x] = y


class Floor1:
    def __init__(self, r: BitReader, codebooks: List[Codebook]):
        self.partitions = r.read(5)
        self.partition_classes = [r.read(4) for _ in range(self.partitions)]
        max_class = max(self.partition_classes, default=-1)
        self.class_dims = []
        self.class_subclasses = []
        self.class_masterbooks = []
        self.subclass_books: List[List[int]] = []
        for _ in range(max_class + 1):
            self.class_dims.append(r.read(3) + 1)
            sub = r.read(2)
            self.class_subclasses.append(sub)
            self.class_masterbooks.append(r.read(8) if sub else -1)
            books = []
            for _ in range(1 << sub):
                books.append(r.read(8) - 1)
            self.subclass_books.append(books)
        self.multiplier = r.read(2) + 1
        rangebits = r.read(4)
        xs = [0, 1 << rangebits]
        for p in range(self.partitions):
            cls = self.partition_classes[p]
            for _ in range(self.class_dims[cls]):
                xs.append(r.read(rangebits))
        if len(set(xs)) != len(xs):
            raise ValueError("Vorbis floor1 X list has duplicates")
        self.x_list = xs
        self.posts = len(xs)
        order = sorted(range(self.posts), key=lambda i: xs[i])
        self.sorted_index = order
        # neighbor tables (spec low_neighbor/high_neighbor over raw order)
        self.lo_nb = []
        self.hi_nb = []
        for i in range(2, self.posts):
            lo, hi = 0, 1
            for j in range(i):
                if xs[j] < xs[i] and xs[j] > xs[lo]:
                    lo = j
                if xs[j] > xs[i] and xs[j] < xs[hi]:
                    hi = j
            self.lo_nb.append(lo)
            self.hi_nb.append(hi)
        self.codebooks = codebooks

    def decode(self, r: BitReader) -> Optional[List[int]]:
        """→ final_y posts (step2-filtered later) or None when unused."""
        if not r.read_bit():
            return None
        rng = _FLOOR1_RANGES[self.multiplier - 1]
        bits = ilog(rng - 1)
        y = [r.read(bits), r.read(bits)]
        for p in range(self.partitions):
            cls = self.partition_classes[p]
            cdim = self.class_dims[cls]
            cbits = self.class_subclasses[cls]
            csub = (1 << cbits) - 1
            cval = 0
            if cbits:
                cval = self.codebooks[self.class_masterbooks[cls]].decode(r)
            for _ in range(cdim):
                book = self.subclass_books[cls][cval & csub]
                cval >>= cbits
                y.append(self.codebooks[book].decode(r) if book >= 0 else 0)
        # amplitude prediction (spec 7.2.2 "synthesis, step 1")
        final_y = [y[0], y[1]]
        step2 = [True, True]
        for i in range(2, self.posts):
            lo, hi = self.lo_nb[i - 2], self.hi_nb[i - 2]
            pred = _render_point(
                self.x_list[lo], final_y[lo], self.x_list[hi], final_y[hi],
                self.x_list[i],
            )
            val = y[i]
            highroom = rng - pred
            lowroom = pred
            room = 2 * min(highroom, lowroom)
            if val:
                step2.append(True)
                step2[lo] = True
                step2[hi] = True
                if val >= room:
                    if highroom > lowroom:
                        fy = val - lowroom + pred
                    else:
                        fy = pred - (val - highroom) - 1
                elif val & 1:
                    fy = pred - ((val + 1) >> 1)
                else:
                    fy = pred + (val >> 1)
            else:
                step2.append(False)
                fy = pred
            final_y.append(fy)
        self._last_step2 = step2
        return final_y

    def curve(self, final_y: List[int], n: int) -> np.ndarray:
        """Render posts → linear floor curve of length n (spec step 2)."""
        rng = _FLOOR1_RANGES[self.multiplier - 1]
        step2 = self._last_step2
        order = self.sorted_index
        v = np.zeros(n, dtype=np.int64)
        # first used post pair-wise line rendering over sorted X
        lx, ly = 0, min(max(final_y[order[0]], 0), rng - 1) * self.multiplier
        for idx in order[1:]:
            if not step2[idx]:
                continue
            hx = self.x_list[idx]
            hy = min(max(final_y[idx], 0), rng - 1) * self.multiplier
            if hx >= n:
                _render_line(lx, ly, hx, hy, v, n)
                lx, ly = hx, hy
                break
            _render_line(lx, ly, hx, hy, v, n)
            lx, ly = hx, hy
        if lx < n:
            v[lx:] = ly
        np.clip(v, 0, 255, out=v)
        return _INVERSE_DB[v]


# ---------------------------------------------------------------------------
# Residues (types 0, 1, 2)
# ---------------------------------------------------------------------------


class Residue:
    def __init__(self, rtype: int, r: BitReader, codebooks: List[Codebook]):
        self.type = rtype
        self.begin = r.read(24)
        self.end = r.read(24)
        self.partition_size = r.read(24) + 1
        self.classifications = r.read(6) + 1
        self.classbook = r.read(8)
        cascades = []
        for _ in range(self.classifications):
            high = 0
            low = r.read(3)
            if r.read_bit():
                high = r.read(5)
            cascades.append((high << 3) | low)
        self.cascades = cascades
        self.books: List[List[int]] = []
        for c in range(self.classifications):
            row = []
            for p in range(8):
                row.append(r.read(8) if cascades[c] & (1 << p) else -1)
            self.books.append(row)
        self.codebooks = codebooks
        cb = codebooks[self.classbook]
        if cb.dims <= 0:
            raise ValueError("Vorbis residue classbook has zero dimensions")

    def decode(self, r: BitReader, ch_vectors: List[np.ndarray],
               do_not_decode: List[bool], n_half: int):
        """Decode residues IN PLACE into ch_vectors (each length n_half)."""
        books = self.codebooks
        classbook = books[self.classbook]
        cpc = classbook.dims  # classwords per codeword
        if self.type == 2:
            ch = len(ch_vectors)
            if all(do_not_decode):
                return
            big = np.zeros(ch * n_half, dtype=np.float32)
            self._decode_core(r, [big], [False], ch * n_half)
            for j in range(ch):
                ch_vectors[j] += big[j::ch]
            return
        self._decode_core(r, ch_vectors, do_not_decode, n_half)

    def _decode_core(self, r: BitReader, vectors: List[np.ndarray],
                     do_not_decode: List[bool], actual_size: int):
        books = self.codebooks
        classbook = books[self.classbook]
        cpc = classbook.dims
        begin = min(self.begin, actual_size)
        end = min(self.end, actual_size)
        n_to_read = end - begin
        if n_to_read <= 0:
            return
        if n_to_read % self.partition_size:
            raise ValueError("Vorbis residue range not partition-aligned")
        parts = n_to_read // self.partition_size
        ch = len(vectors)
        classifs = [[0] * (parts + cpc) for _ in range(ch)]
        for p in range(8):  # passes
            pcount = 0
            while pcount < parts:
                if p == 0:
                    for j in range(ch):
                        if do_not_decode[j]:
                            continue
                        try:
                            temp = classbook.decode(r)
                        except EOFError:
                            return
                        for i in range(cpc - 1, -1, -1):
                            classifs[j][i + pcount] = temp % self.classifications
                            temp //= self.classifications
                for i in range(cpc):
                    if pcount >= parts:
                        break
                    for j in range(ch):
                        if do_not_decode[j]:
                            continue
                        vq = classifs[j][pcount]
                        book = self.books[vq][p]
                        if book < 0:
                            continue
                        off = begin + pcount * self.partition_size
                        try:
                            self._partition(r, books[book], vectors[j], off)
                        except EOFError:
                            return
                    pcount += 1

    def _partition(self, r: BitReader, book: Codebook, v: np.ndarray, off: int):
        psize = self.partition_size
        dims = book.dims
        if self.type == 0:
            step = psize // dims
            for k in range(step):
                e = book.decode_vq(r)
                v[off + k : off + k + step * dims : step] += e
        else:  # types 1 and 2 (2 runs on the interleaved vector)
            if book.vectors is not None and _native.available():
                count = psize // dims
                handle = book._native_handle
                if handle is None or len(handle.scratch) < count * dims:
                    handle = _native.BookHandle(book.fast, book.vectors, count)
                    book._native_handle = handle
                newpos = _native.vq_run(
                    r.data, r.bits_consumed(), handle, count,
                    fast_bits=_FAST_BITS,
                )
                if newpos >= 0:
                    v[off : off + count * dims] += handle.scratch[: count * dims]
                    r.seek_bits(newpos)
                    if psize % dims:  # ragged tail: finish in Python
                        for k in range(count * dims, psize, dims):
                            e = book.decode_vq(r)
                            v[off + k : off + k + dims] += e
                    return
                # fast-table miss / packet end → Python path from where we were
            k = 0
            while k < psize:
                e = book.decode_vq(r)
                v[off + k : off + k + dims] += e
                k += dims


# ---------------------------------------------------------------------------
# Mappings and modes
# ---------------------------------------------------------------------------


class Mapping:
    def __init__(self, r: BitReader, channels: int, n_floors: int,
                 n_residues: int):
        self.submaps = r.read(4) + 1 if r.read_bit() else 1
        self.coupling: List[Tuple[int, int]] = []
        if r.read_bit():
            steps = r.read(8) + 1
            bits = ilog(channels - 1)
            for _ in range(steps):
                mag = r.read(bits)
                ang = r.read(bits)
                if mag == ang or mag >= channels or ang >= channels:
                    raise ValueError("Vorbis mapping: invalid coupling pair")
                self.coupling.append((mag, ang))
        if r.read(2):
            raise ValueError("Vorbis mapping: reserved bits set")
        if self.submaps > 1:
            self.mux = [r.read(4) for _ in range(channels)]
            if any(m >= self.submaps for m in self.mux):
                raise ValueError("Vorbis mapping: mux exceeds submap count")
        else:
            self.mux = [0] * channels
        self.submap_floor = []
        self.submap_residue = []
        for _ in range(self.submaps):
            r.read(8)  # unused time config
            f = r.read(8)
            res = r.read(8)
            if f >= n_floors or res >= n_residues:
                raise ValueError("Vorbis mapping: floor/residue out of range")
            self.submap_floor.append(f)
            self.submap_residue.append(res)


# ---------------------------------------------------------------------------
# IMDCT + window
# ---------------------------------------------------------------------------


def _imdct_slow(spec: np.ndarray, n: int) -> np.ndarray:
    """Direct O(n²) spec-formula IMDCT (tests only)."""
    m = n // 2
    ks = np.arange(m)
    out = np.zeros(n)
    for i in range(n):
        out[i] = np.sum(
            spec[:m] * np.cos((np.pi / (2 * m)) * (2 * i + 1 + m) * (2 * ks + 1) / 2)
        )
    return out


def imdct(spec: np.ndarray, n: int) -> np.ndarray:
    """Vorbis IMDCT via DCT-IV: y[i] = Σ_k X[k]·cos(π/(2M)·(i+½+M/2)·(2k+1)),
    M = n/2.  The DCT-IV d[j] = Σ X[k]·cos(π/M·(j+½)(k+½)) gives the four
    output quadrants by shift/mirror symmetry (verified vs _imdct_slow)."""
    from scipy.fft import dct

    m = n // 2
    d = dct(np.asarray(spec[:m], dtype=np.float64), type=4) * 0.5
    half = m // 2
    out = np.empty(n)
    # i ∈ [0, M/2): arg index j = i + M/2
    out[:half] = d[half:]
    # i ∈ [M/2, 3M/2): mirrors with sign flip
    out[half : half + m] = -d[::-1]
    # i ∈ [3M/2, 2M): −d[j − 3M/2 mirrored]
    out[half + m :] = -d[:half]
    return out


def vorbis_window(n: int) -> np.ndarray:
    i = np.arange(n)
    return np.sin(0.5 * np.pi * np.sin((i + 0.5) / n * np.pi) ** 2)


# ---------------------------------------------------------------------------
# Top-level decoder
# ---------------------------------------------------------------------------


class _Setup:
    pass


def _parse_headers(packets) -> Tuple[_Setup, int]:
    """Parse the three header packets → (setup, index of first audio pkt)."""
    s = _Setup()
    idp, _g = packets[0]
    if len(idp) < 30 or idp[0] != 1 or idp[1:7] != b"vorbis":
        if idp[:8] == b"OpusHead":
            raise UnsupportedCodec(
                "Ogg stream contains Opus, not Vorbis — install ffmpeg to "
                "decode Opus"
            )
        raise UnsupportedCodec("not a Vorbis stream (bad identification header)")
    version, channels = struct.unpack_from("<IB", idp, 7)
    rate = struct.unpack_from("<I", idp, 12)[0]
    if version != 0:
        raise ValueError(f"unsupported Vorbis version {version}")
    if channels == 0 or rate == 0:
        raise ValueError("Vorbis id header: zero channels or rate")
    bs = idp[28]
    s.blocksize0 = 1 << (bs & 0x0F)
    s.blocksize1 = 1 << (bs >> 4)
    if not (64 <= s.blocksize0 <= 8192 and s.blocksize0 <= s.blocksize1 <= 8192):
        raise ValueError("Vorbis id header: invalid blocksizes")
    if not (idp[29] & 1):
        raise ValueError("Vorbis id header: framing bit unset")
    s.channels = channels
    s.rate = rate

    first_audio = None
    setup_pkt = None
    for i in range(1, len(packets)):
        p, _ = packets[i]
        if not p:
            continue
        if p[0] == 3 and p[1:7] == b"vorbis":
            continue  # comment header — skipped
        if p[0] == 5 and p[1:7] == b"vorbis":
            setup_pkt = p
            first_audio = i + 1
            break
        raise ValueError("Vorbis header packets out of order")
    if setup_pkt is None:
        raise ValueError("Vorbis setup header missing (truncated stream)")

    r = BitReader(setup_pkt[7:])
    n_books = r.read(8) + 1
    s.codebooks = [Codebook(r) for _ in range(n_books)]
    for _ in range(r.read(6) + 1):  # time domain transforms (placeholders)
        if r.read(16) != 0:
            raise ValueError("Vorbis setup: nonzero time transform")
    s.floors = []
    for _ in range(r.read(6) + 1):
        ftype = r.read(16)
        if ftype == 1:
            s.floors.append(Floor1(r, s.codebooks))
        elif ftype == 0:
            raise UnsupportedCodec(
                "Vorbis floor type 0 (LSP) is not supported by the native "
                "decoder — no mainstream encoder emits it; install ffmpeg "
                "for such streams"
            )
        else:
            raise ValueError(f"Vorbis setup: reserved floor type {ftype}")
    s.residues = []
    for _ in range(r.read(6) + 1):
        rtype = r.read(16)
        if rtype > 2:
            raise ValueError(f"Vorbis setup: reserved residue type {rtype}")
        s.residues.append(Residue(rtype, r, s.codebooks))
    s.mappings = []
    for _ in range(r.read(6) + 1):
        if r.read(16) != 0:
            raise ValueError("Vorbis setup: reserved mapping type")
        s.mappings.append(Mapping(r, channels, len(s.floors), len(s.residues)))
    s.modes = []
    for _ in range(r.read(6) + 1):
        blockflag = r.read_bit()
        if r.read(16) or r.read(16):
            raise ValueError("Vorbis setup: reserved mode window/transform")
        mapping = r.read(8)
        if mapping >= len(s.mappings):
            raise ValueError("Vorbis setup: mode mapping out of range")
        s.modes.append((blockflag, mapping))
    if not r.read_bit():
        raise ValueError("Vorbis setup: framing bit unset")
    return s, first_audio


def _window_geometry(n: int, long_block: bool, prev_flag: int, next_flag: int,
                     n_short: int):
    if long_block:
        left_start = n // 4 - (n if prev_flag else n_short) // 4
        left_n = (n if prev_flag else n_short) // 2
        right_start = 3 * n // 4 - (n if next_flag else n_short) // 4
        right_n = (n if next_flag else n_short) // 2
    else:
        left_start, left_n = 0, n // 2
        right_start, right_n = n // 2, n // 2
    return left_start, left_n, right_start, right_n


def _build_window(n: int, long_block: bool, prev_flag: int, next_flag: int,
                  n_short: int) -> np.ndarray:
    ls, ln, rs, rn = _window_geometry(n, long_block, prev_flag, next_flag, n_short)
    w = np.zeros(n)
    i = np.arange(ln)
    w[ls : ls + ln] = np.sin(
        0.5 * np.pi * np.sin((i + 0.5) / ln * 0.5 * np.pi) ** 2
    )
    w[ls + ln : rs] = 1.0
    i = np.arange(rn)
    w[rs : rs + rn] = np.sin(
        0.5 * np.pi * np.sin((i + 0.5) / rn * 0.5 * np.pi + 0.5 * np.pi) ** 2
    )
    return w


def _decode_packet(s: _Setup, packet: bytes):
    """One audio packet → (per-channel spectral arrays, blockflag,
    prev/next window flags) or None for an undecodable packet."""
    r = BitReader(packet)
    if r.read_bit() != 0:
        return None  # not an audio packet
    mode_idx = r.read(ilog(len(s.modes) - 1))
    if mode_idx >= len(s.modes):
        return None
    blockflag, mapping_idx = s.modes[mode_idx]
    n = s.blocksize1 if blockflag else s.blocksize0
    prev_flag = next_flag = 1
    if blockflag:
        prev_flag = r.read_bit()
        next_flag = r.read_bit()
    mapping = s.mappings[mapping_idx]
    half = n // 2
    ch = s.channels

    floors_cfg = [s.floors[mapping.submap_floor[mapping.mux[j]]] for j in range(ch)]
    floor_posts: List[Optional[List[int]]] = []
    step2_flags: List[Optional[List[bool]]] = []
    try:
        for j in range(ch):
            posts = floors_cfg[j].decode(r)
            floor_posts.append(posts)
            step2_flags.append(
                list(floors_cfg[j]._last_step2) if posts is not None else None
            )
    except EOFError:
        # spec 4.3.2: end-of-packet during floor decode → the FRAME is
        # silent but still windowed/lapped (timing must not shift)
        zeros = [np.zeros(half, dtype=np.float32) for _ in range(ch)]
        return zeros, blockflag, prev_flag, next_flag, n

    no_residue = [p is None for p in floor_posts]
    for mag, ang in mapping.coupling:
        if not (no_residue[mag] and no_residue[ang]):
            no_residue[mag] = no_residue[ang] = False

    vectors = [np.zeros(half, dtype=np.float32) for _ in range(ch)]
    for sm in range(mapping.submaps):
        idxs = [j for j in range(ch) if mapping.mux[j] == sm]
        res = s.residues[mapping.submap_residue[sm]]
        res.decode(
            r,
            [vectors[j] for j in idxs],
            [no_residue[j] for j in idxs],
            half,
        )

    for mag, ang in reversed(mapping.coupling):
        m = vectors[mag]
        a = vectors[ang]
        # spec square-polar inversion (8.5.2):
        #   M>0, A>0 → (M, M−A);  M>0, A≤0 → (M+A, M)
        #   M≤0, A>0 → (M, M+A);  M≤0, A≤0 → (M−A, M)
        pos_a = a > 0
        new_m = np.where(pos_a, m, np.where(m > 0, m + a, m - a))
        new_a = np.where(pos_a, np.where(m > 0, m - a, m + a), m)
        vectors[mag] = new_m.astype(np.float32)
        vectors[ang] = new_a.astype(np.float32)

    spectra = []
    for j in range(ch):
        if floor_posts[j] is None:
            spectra.append(np.zeros(half, dtype=np.float32))
            continue
        fl = floors_cfg[j]
        fl._last_step2 = step2_flags[j]
        curve = fl.curve(floor_posts[j], half)
        spectra.append(vectors[j] * curve)
    return spectra, blockflag, prev_flag, next_flag, n


# Vorbis I spec §4.3.9 fixes the channel order for 1-8 channels (e.g. 5.1
# is L C R RL RR LFE); the product convention — like WAV and the reference's
# libsndfile — is FL FR C LFE RL RR (config.CHANNEL_LAYOUTS).  These tables
# map spec order → WAV order on decode; vorbisenc applies the inverse on
# encode, so repo round trips are identity AND files interop with real-world
# encoders/decoders (libvorbis, ffmpeg) channel-for-channel.
# WAV_FROM_VORBIS[n][k] = vorbis channel index holding WAV channel k.
WAV_FROM_VORBIS: Dict[int, Tuple[int, ...]] = {
    3: (0, 2, 1),
    5: (0, 2, 1, 3, 4),
    6: (0, 2, 1, 5, 3, 4),
    7: (0, 2, 1, 6, 5, 3, 4),
    8: (0, 2, 1, 7, 5, 6, 3, 4),
}
# VORBIS_FROM_WAV[n][j] = WAV channel index carried by vorbis channel j.
VORBIS_FROM_WAV: Dict[int, Tuple[int, ...]] = {
    n: tuple(perm.index(j) for j in range(n)) for n, perm in WAV_FROM_VORBIS.items()
}


def decode(path_or_file: Union[str, os.PathLike, BinaryIO]) -> Tuple[np.ndarray, int]:
    """Decode an Ogg/Vorbis file → (float32 (samples, channels), rate).

    Multichannel output is in WAV order (FL FR C LFE …), mapped from the
    Vorbis spec order per §4.3.9 — the same convention libsndfile and
    ffmpeg deliver, and what the render pipeline's CHANNEL_LAYOUTS expect.

    Error contract: malformed/adversarial input raises ValueError (or
    UnsupportedCodec for legal-but-non-Vorbis payloads) — never raw
    IndexError/ZeroDivisionError/EOFError from deep inside the setup
    parser (a corrupt setup header can name out-of-range codebooks,
    zero-dimension lookups, truncated packets …).
    """
    try:
        return _decode_impl(path_or_file)
    except (UnsupportedCodec, ValueError):
        raise
    except (IndexError, KeyError, ZeroDivisionError, EOFError, struct.error,
            OverflowError, MemoryError) as e:
        raise ValueError(
            f"corrupt Ogg/Vorbis stream ({type(e).__name__}: {e})"
        ) from e


def _decode_impl(path_or_file) -> Tuple[np.ndarray, int]:
    if hasattr(path_or_file, "read"):
        data = path_or_file.read()
    else:
        with open(path_or_file, "rb") as fh:
            data = fh.read()
    if data[:4] != b"OggS":
        raise ValueError("not an Ogg stream")
    packets, final_granule = _ogg_packets(data)
    s, first_audio = _parse_headers(packets)
    n_short = s.blocksize0

    out_chunks: List[Tuple[int, np.ndarray]] = []  # (abs position, (ch, n))
    pos = 0
    prev_geom = None  # (right_start, n) of the previous frame
    first_center = None
    win_cache: Dict[Tuple[int, int, int, int], np.ndarray] = {}

    total_frames = 0
    for pkt, _gran in packets[first_audio:]:
        if not pkt:
            continue
        try:
            decoded = _decode_packet(s, pkt)
        except (EOFError, ValueError):
            continue  # corrupt audio packet — skip (Vorbis is lossy-robust)
        if decoded is None:
            continue
        spectra, blockflag, prev_flag, next_flag, n = decoded
        key = (n, blockflag, prev_flag, next_flag)
        if key not in win_cache:
            win_cache[key] = _build_window(n, bool(blockflag), prev_flag,
                                           next_flag, n_short)
        w = win_cache[key]
        ls, ln, rs, rn = _window_geometry(n, bool(blockflag), prev_flag,
                                          next_flag, n_short)
        frame = np.stack([imdct(sp, n) for sp in spectra]) * w
        if prev_geom is None:
            pos = 0
            first_center = n // 2
        else:
            prev_rs, _prev_n = prev_geom
            pos = pos + prev_rs - ls
        out_chunks.append((pos, frame.astype(np.float32)))
        prev_geom = (rs, n)
        total_frames += 1

    if total_frames == 0:
        raise ValueError("Ogg/Vorbis stream contains no decodable audio")

    # A short final block after a long one ends BEFORE the long frame does
    # (last_pos + last_width under-sizes the buffer and the long frame's
    # overlap-add would broadcast-crash); a short→long opening can compute
    # a negative first position.  Size from the true extents and shift.
    shift = -min(0, min(p for p, _ in out_chunks))
    if shift:
        out_chunks = [(p + shift, f) for p, f in out_chunks]
        first_center += shift
    last_pos, last_frame = out_chunks[-1]
    end = max(p + f.shape[1] for p, f in out_chunks)
    buf = np.zeros((s.channels, end), dtype=np.float32)
    for p, frame in out_chunks:
        buf[:, p : p + frame.shape[1]] += frame

    valid_start = first_center
    last_n = last_frame.shape[1]
    valid_end = last_pos + last_n // 2
    produced = valid_end - valid_start
    if final_granule >= 0:
        produced = min(produced, final_granule)
    if produced <= 0:
        raise ValueError("Ogg/Vorbis stream decodes to zero samples")
    out = buf[:, valid_start : valid_start + produced]
    perm = WAV_FROM_VORBIS.get(s.channels)
    if perm is not None:
        out = out[list(perm)]
    return np.ascontiguousarray(out.T), s.rate


_PROBE_WINDOW = 1 << 16  # 64 KiB head/tail — bounds probe I/O and CPU


def _last_valid_granule(tail: bytes, serial: int) -> int:
    """Granule of the last CRC-valid page of ``serial`` inside ``tail``,
    or −1 when no complete page verifies in the window."""
    i = tail.rfind(b"OggS")
    while i >= 0:
        if i + 27 <= len(tail) and tail[i + 4] == 0:
            nseg = tail[i + 26]
            hdr_end = i + 27 + nseg
            if hdr_end <= len(tail):
                body_len = sum(tail[i + 27 : hdr_end])
                end = hdr_end + body_len
                page_serial = struct.unpack_from("<I", tail, i + 14)[0]
                if end <= len(tail) and page_serial == serial:
                    page = bytearray(tail[i:end])
                    crc = struct.unpack_from("<I", page, 22)[0]
                    page[22:26] = b"\x00\x00\x00\x00"
                    if ogg_crc(bytes(page)) == crc:
                        g = struct.unpack_from("<q", tail, i + 6)[0]
                        if g >= 0:
                            return g
        i = tail.rfind(b"OggS", 0, i)
    return -1


def probe(path_or_file: Union[str, os.PathLike, BinaryIO]) -> dict:
    """Bounded metadata probe: rate/channels from the identification header
    in the HEAD window, frames from the last CRC-valid page granule in the
    TAIL window.  The full page walk (every page CRC-checked — minutes of
    pure-Python CRC for hour-long clips) runs only as the fallback when no
    complete page verifies inside the tail window; directory bucketing
    (cli.render_dir) probes many files and must stay cheap."""
    whole = None
    if hasattr(path_or_file, "read"):
        whole = path_or_file.read()
        head, tail = whole[:_PROBE_WINDOW], whole[-_PROBE_WINDOW:]
    else:
        with open(path_or_file, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            size = fh.tell()
            fh.seek(0)
            if size <= 2 * _PROBE_WINDOW:
                whole = fh.read()
                head, tail = whole, whole
            else:
                head = fh.read(_PROBE_WINDOW)
                fh.seek(size - _PROBE_WINDOW)
                tail = fh.read(_PROBE_WINDOW)
    if head[:4] != b"OggS":
        raise ValueError("not an Ogg stream")
    if len(head) < 28:
        raise ValueError("truncated Ogg stream")
    serial = struct.unpack_from("<I", head, 14)[0]
    seg_count = head[26]
    segs = head[27 : 27 + seg_count]
    first_seg = segs[0] if len(segs) else 0
    idp = head[27 + seg_count : 27 + seg_count + first_seg]
    if len(idp) < 30 or idp[0] != 1 or idp[1:7] != b"vorbis":
        raise UnsupportedCodec("not a Vorbis stream")
    channels = idp[11]
    rate = struct.unpack_from("<I", idp, 12)[0]
    final_granule = _last_valid_granule(tail, serial)
    if final_granule < 0:
        # no verifiable page in the tail window → exact full walk
        if whole is None:
            with open(path_or_file, "rb") as fh:
                whole = fh.read()
        _, final_granule = _ogg_packets(whole)
    frames = int(max(final_granule, 0))
    return {
        "samplerate": int(rate),
        "channels": int(channels),
        "frames": frames,
        "duration": frames / rate if rate > 0 else 0.0,
        "format": "OGG/Vorbis",
    }
