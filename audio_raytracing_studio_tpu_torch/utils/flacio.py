"""FLAC codec — the port's own copy of ``audio_raytracing_studio_tpu/utils/
flacio.py`` (host code: Python / NumPy with the optional C++ hot loops of
``_native/flac_core.cc``, built at first use).

The reference studio reads FLAC through soundfile/libsndfile (its
raytracer_studio.py:1013) and converts formats via pydub/ffmpeg (its
analyser.py:73-83); this codec needs neither:

Decoder — the full subset needed to read real-world files:
  * CONSTANT / VERBATIM / FIXED(0-4) / LPC(1-32) subframes
  * rice and rice2 residual partitions, escape partitions, wasted bits
  * independent / left-side / right-side / mid-side channel decorrelation
  * 8/12/16/20/24-bit, 1-8 channels, fixed and variable blocking
  * CRC-8 header and CRC-16 frame verification, STREAMINFO MD5 check

Encoder — a genuine lossless compressor (not verbatim storage):
  * per-frame best-of fixed predictors (orders 0-4) per channel
  * per-frame stereo decorrelation choice (independent/LS/RS/MS)
  * rice residual coding with per-partition parameter search
  * spec-compliant CRCs and STREAMINFO (incl. the raw-sample MD5)

Everything is integer-exact per the format spec; round-trips are
bit-identical, and the bytes equal the JAX package's encoder's
(tests/test_torch_codecs.py).
"""

from __future__ import annotations

import hashlib
import os
from typing import BinaryIO, List, Tuple, Union

import numpy as np

# native rice / LPC hot loops (C++, built at first use); where g++ cannot
# build them, _nf.available() is False and the NumPy paths run
from . import _native_flac as _nf

MAGIC = b"fLaC"
DEFAULT_BLOCK = 4096

# frame-header 4-bit sample-rate codes (Hz) — index = code
_RATE_CODES = {
    88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5, 22050: 6,
    24000: 7, 32000: 8, 44100: 9, 48000: 10, 96000: 11,
}
_RATE_FROM_CODE = {v: k for k, v in _RATE_CODES.items()}
_BPS_CODES = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6}
_BPS_FROM_CODE = {v: k for k, v in _BPS_CODES.items()}

_FIXED_COEFFS = {
    0: np.array([], dtype=np.int64),
    1: np.array([1], dtype=np.int64),
    2: np.array([2, -1], dtype=np.int64),
    3: np.array([3, -3, 1], dtype=np.int64),
    4: np.array([4, -6, 4, -1], dtype=np.int64),
}


def _crc_table(poly: int, width: int) -> np.ndarray:
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    table = np.zeros(256, dtype=np.uint32)
    for byte in range(256):
        crc = byte << (width - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) if crc & top else (crc << 1)
        table[byte] = crc & mask
    return table


_CRC8_TABLE = _crc_table(0x07, 8)
_CRC16_TABLE = _crc_table(0x8005, 16)


def crc8(data: bytes) -> int:
    if _nf.available():
        return _nf.crc8(data)
    crc = 0
    for b in data:
        crc = int(_CRC8_TABLE[crc ^ b])
    return crc


def crc16(data: bytes) -> int:
    if _nf.available():
        return _nf.crc16(data)
    crc = 0
    for b in data:
        crc = (int(_CRC16_TABLE[(crc >> 8) ^ b]) ^ (crc << 8)) & 0xFFFF
    return crc


# ---------------------------------------------------------------------------
# bit-level IO
# ---------------------------------------------------------------------------


class BitReader:
    """MSB-first bit reader over a bytes buffer.

    Memory trade-off (deliberate): the whole buffer is unpacked to one
    byte per bit up front (~8× the compressed size, e.g. ~3 GB transient
    for an hour-scale 350 MB FLAC) because the native rice hot loop
    (utils/_native/flac_core.cc) consumes the unpacked array directly —
    an incremental word-based reader would bound memory at the file size
    but serialize the hot loop behind per-call repacking.  Typical product
    clips (minutes, tens of MB) stay well inside this box's RAM; hour-scale
    inputs should prefer WAV, which streams.
    """

    def __init__(self, data: bytes):
        self.data = data
        self.bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8))
        self.pos = 0  # bit position
        self._ones_cache = None

    @property
    def _ones(self) -> np.ndarray:
        """Set-bit positions — only the pure-Python unary/rice paths need it."""
        if self._ones_cache is None:
            self._ones_cache = np.flatnonzero(self.bits)
        return self._ones_cache

    def byte_pos(self) -> int:
        return self.pos >> 3

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def read_uint(self, n: int) -> int:
        if n == 0:
            return 0
        chunk = self.bits[self.pos : self.pos + n]
        if chunk.size < n:
            raise EOFError("FLAC bitstream truncated")
        self.pos += n
        val = 0
        for b in chunk.tolist():
            val = (val << 1) | b
        return val

    def read_sint(self, n: int) -> int:
        v = self.read_uint(n)
        if v >= 1 << (n - 1):
            v -= 1 << n
        return v

    def read_unary(self) -> int:
        # rare outside rice blocks (wasted-bits counts): direct forward scan
        bits, idx = self.bits, self.pos
        while idx < bits.size and not bits[idx]:
            idx += 1
        if idx >= bits.size:
            raise EOFError("FLAC bitstream truncated in unary code")
        q = idx - self.pos
        self.pos = idx + 1
        return q

    def read_rice_block(self, k: int, n: int) -> np.ndarray:
        """Decode n rice(k) residuals (unary quotient + k low bits, zigzag)."""
        if _nf.available():
            out, self.pos = _nf.rice_decode(self.bits, self.pos, k, n)
            return out
        out = np.empty(n, dtype=np.int64)
        bits, ones, pos = self.bits, self._ones, self.pos
        idx = int(np.searchsorted(ones, pos))
        nbits = bits.size
        for i in range(n):
            if idx >= ones.size:
                raise EOFError("FLAC bitstream truncated in rice code")
            stop = int(ones[idx])
            q = stop - pos
            pos = stop + 1
            if k:
                if pos + k > nbits:
                    raise EOFError("FLAC bitstream truncated in rice code")
                low = 0
                for b in bits[pos : pos + k].tolist():
                    low = (low << 1) | b
                pos += k
                # low-bit fields may contain set bits: skip them in `ones`
                idx = int(np.searchsorted(ones, pos))
            else:
                idx += 1
            u = (q << k) | low if k else q
            out[i] = (u >> 1) ^ -(u & 1)  # zigzag → signed
        self.pos = pos
        return out

    def read_utf8_number(self) -> int:
        """FLAC's UTF-8-style coded number (frame/sample index, up to 36 bits)."""
        first = self.read_uint(8)
        if first < 0x80:
            return first
        n_follow = 0
        mask = 0x40
        while first & mask:
            n_follow += 1
            mask >>= 1
        if n_follow == 0 or n_follow > 6:
            raise ValueError("invalid FLAC coded number")
        val = first & (mask - 1)
        for _ in range(n_follow):
            b = self.read_uint(8)
            if (b & 0xC0) != 0x80:
                raise ValueError("invalid FLAC coded number continuation")
            val = (val << 6) | (b & 0x3F)
        return val


class BitWriter:
    """MSB-first bit writer (collects bits, packs to bytes at the end)."""

    def __init__(self):
        self._bits: List[np.ndarray] = []
        self._nbits = 0

    def write_uint(self, value: int, n: int) -> None:
        if n == 0:
            return
        arr = np.zeros(n, dtype=np.uint8)
        for i in range(n - 1, -1, -1):
            arr[i] = value & 1
            value >>= 1
        self._bits.append(arr)
        self._nbits += n

    def write_sint(self, value: int, n: int) -> None:
        self.write_uint(value & ((1 << n) - 1), n)

    def write_unary(self, q: int) -> None:
        arr = np.zeros(q + 1, dtype=np.uint8)
        arr[-1] = 1
        self._bits.append(arr)
        self._nbits += q + 1

    def write_rice_block(self, residuals: np.ndarray, k: int) -> None:
        u = residuals.astype(np.int64)
        u = (u << 1) ^ (u >> 63)  # zigzag
        q = (u >> k).astype(np.int64)
        total = int(q.sum()) + u.size * (1 + k)
        if _nf.available():
            self._bits.append(_nf.rice_encode(u.astype(np.uint64), k, total))
            self._nbits += total
            return
        arr = np.zeros(total, dtype=np.uint8)
        pos = 0
        low_mask = (1 << k) - 1
        for i in range(u.size):
            qi = int(q[i])
            pos += qi
            arr[pos] = 1
            pos += 1
            if k:
                low = int(u[i]) & low_mask
                for j in range(k - 1, -1, -1):
                    arr[pos + j] = low & 1
                    low >>= 1
                pos += k
        self._bits.append(arr)
        self._nbits += total

    def write_utf8_number(self, value: int) -> None:
        if value < 0x80:
            self.write_uint(value, 8)
            return
        groups = []
        v = value
        while True:
            groups.append(v & 0x3F)
            v >>= 6
            n = len(groups)
            # leading byte holds (7 - n) payload bits for n continuation bytes
            if v < (1 << (6 - n)) and n <= 6:
                break
        lead = ((0xFF << (7 - len(groups))) & 0xFF) | v
        self.write_uint(lead, 8)
        for g in reversed(groups):
            self.write_uint(0x80 | g, 8)

    def align(self) -> None:
        pad = (-self._nbits) % 8
        if pad:
            self.write_uint(0, pad)

    def getvalue(self) -> bytes:
        self.align()
        if not self._bits:
            return b""
        return np.packbits(np.concatenate(self._bits)).tobytes()

    def __len__(self) -> int:  # current bit length
        return self._nbits


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------


class StreamInfo:
    def __init__(self, raw: bytes):
        r = BitReader(raw)
        self.min_blocksize = r.read_uint(16)
        self.max_blocksize = r.read_uint(16)
        self.min_framesize = r.read_uint(24)
        self.max_framesize = r.read_uint(24)
        self.sample_rate = r.read_uint(20)
        self.channels = r.read_uint(3) + 1
        self.bits_per_sample = r.read_uint(5) + 1
        self.total_samples = r.read_uint(36)
        self.md5 = raw[18:34]


def _decode_residual(r: BitReader, blocksize: int, pred_order: int) -> np.ndarray:
    method = r.read_uint(2)
    if method not in (0, 1):
        raise ValueError(f"unsupported FLAC residual method {method}")
    param_bits = 4 if method == 0 else 5
    escape = (1 << param_bits) - 1
    part_order = r.read_uint(4)
    nparts = 1 << part_order
    if blocksize % nparts:
        raise ValueError("invalid FLAC partition order")
    out = np.empty(blocksize - pred_order, dtype=np.int64)
    o = 0
    for p in range(nparts):
        n = blocksize // nparts - (pred_order if p == 0 else 0)
        k = r.read_uint(param_bits)
        if k == escape:
            raw_bits = r.read_uint(5)
            vals = np.empty(n, dtype=np.int64)
            for i in range(n):
                vals[i] = r.read_sint(raw_bits) if raw_bits else 0
            out[o : o + n] = vals
        else:
            out[o : o + n] = r.read_rice_block(k, n)
        o += n
    return out


def _refixed_exact(order: int, warmup: np.ndarray, residual: np.ndarray) -> np.ndarray:
    """Reconstruct a FIXED subframe: o-fold integer cumsum seeded from the
    warmup's backward differences (differencing is linear and exact in int64)."""
    n = warmup.size + residual.size
    out = np.empty(n, dtype=np.int64)
    out[: warmup.size] = warmup
    # d^order applied to the true signal equals the residual; invert by
    # repeated cumsum over the tail with warmup-derived seeds.
    diffs = [warmup.astype(np.int64)]
    for _ in range(order):
        diffs.append(np.diff(diffs[-1]))
    tail = residual.astype(np.int64)
    for o in range(order, 0, -1):
        seed = diffs[o - 1][-1]  # last warmup value at difference level o-1
        tail = seed + np.cumsum(tail)
    out[warmup.size :] = tail
    return out


def _decode_subframe(r: BitReader, blocksize: int, bps: int) -> np.ndarray:
    if r.read_uint(1) != 0:
        raise ValueError("invalid FLAC subframe padding bit")
    sf_type = r.read_uint(6)
    wasted = 0
    if r.read_uint(1):
        wasted = 1 + r.read_unary()
    eff_bps = bps - wasted

    if sf_type == 0:  # CONSTANT
        val = r.read_sint(eff_bps)
        out = np.full(blocksize, val, dtype=np.int64)
    elif sf_type == 1:  # VERBATIM
        out = np.empty(blocksize, dtype=np.int64)
        for i in range(blocksize):
            out[i] = r.read_sint(eff_bps)
    elif 8 <= sf_type <= 12:  # FIXED
        order = sf_type - 8
        warmup = np.array([r.read_sint(eff_bps) for _ in range(order)], dtype=np.int64)
        residual = _decode_residual(r, blocksize, order)
        out = _refixed_exact(order, warmup, residual)
    elif sf_type >= 32:  # LPC
        order = sf_type - 31
        warmup = np.array([r.read_sint(eff_bps) for _ in range(order)], dtype=np.int64)
        precision = r.read_uint(4) + 1
        if precision == 16:
            raise ValueError("invalid FLAC LPC precision escape")
        shift = r.read_sint(5)
        if shift < 0:
            raise ValueError("negative FLAC LPC shift")
        coeffs = np.array([r.read_sint(precision) for _ in range(order)], dtype=np.int64)
        residual = _decode_residual(r, blocksize, order)
        out = np.empty(blocksize, dtype=np.int64)
        out[:order] = warmup
        out[order:] = residual
        co = coeffs[::-1].copy()  # oldest-first for the dot product
        if _nf.available():
            out = _nf.lpc_reconstruct(out, co, shift)
        else:
            for i in range(order, blocksize):
                pred = int(np.dot(co, out[i - order : i])) >> shift
                out[i] = out[i] + pred
    else:
        raise ValueError(f"reserved FLAC subframe type {sf_type}")

    if wasted:
        out = out << wasted
    return out


def _decode_frame(r: BitReader, info: StreamInfo) -> Tuple[np.ndarray, int]:
    """Decode one frame → (samples int64 (n, channels), sample rate)."""
    header_start = r.byte_pos()
    sync = r.read_uint(14)
    if sync != 0b11111111111110:
        raise ValueError("lost FLAC frame sync")
    if r.read_uint(1) != 0:
        raise ValueError("invalid FLAC frame reserved bit")
    r.read_uint(1)  # blocking strategy (frame vs sample numbering)
    bs_code = r.read_uint(4)
    sr_code = r.read_uint(4)
    ch_code = r.read_uint(4)
    bps_code = r.read_uint(3)
    if r.read_uint(1) != 0:
        raise ValueError("invalid FLAC frame reserved bit 2")
    r.read_utf8_number()  # frame/sample number (sequential decode ignores it)

    if bs_code == 0:
        raise ValueError("reserved FLAC blocksize code")
    elif bs_code == 1:
        blocksize = 192
    elif bs_code <= 5:
        blocksize = 576 << (bs_code - 2)
    elif bs_code == 6:
        blocksize = r.read_uint(8) + 1
    elif bs_code == 7:
        blocksize = r.read_uint(16) + 1
    else:
        blocksize = 256 << (bs_code - 8)

    if sr_code == 0:
        rate = info.sample_rate
    elif sr_code in _RATE_FROM_CODE:
        rate = _RATE_FROM_CODE[sr_code]
    elif sr_code == 12:
        rate = r.read_uint(8) * 1000
    elif sr_code == 13:
        rate = r.read_uint(16)
    elif sr_code == 14:
        rate = r.read_uint(16) * 10
    else:
        raise ValueError("invalid FLAC sample-rate code")

    bps = info.bits_per_sample if bps_code == 0 else _BPS_FROM_CODE.get(bps_code)
    if bps is None:
        raise ValueError("reserved FLAC sample-size code")

    # header CRC-8 covers everything from sync through the fields above
    crc_pos = r.byte_pos()
    expected = r.read_uint(8)
    if crc8(r.data[header_start:crc_pos]) != expected:
        raise ValueError("FLAC frame header CRC-8 mismatch")

    if ch_code <= 7:
        channels = ch_code + 1
        subs = [_decode_subframe(r, blocksize, bps) for _ in range(channels)]
        frame = np.stack(subs, axis=1)
    elif ch_code in (8, 9, 10):
        # stereo decorrelation: the side channel carries one extra bit
        a = _decode_subframe(r, blocksize, bps + (1 if ch_code == 9 else 0))
        b = _decode_subframe(r, blocksize, bps + (1 if ch_code in (8, 10) else 0))
        if ch_code == 8:  # left / side
            left, right = a, a - b
        elif ch_code == 9:  # side / right
            left, right = a + b, b
        else:  # mid / side
            side = b
            mid = (a << 1) | (side & 1)
            left, right = (mid + side) >> 1, (mid - side) >> 1
        frame = np.stack([left, right], axis=1)
    else:
        raise ValueError(f"reserved FLAC channel assignment {ch_code}")

    r.align()
    crc_pos = r.byte_pos()
    expected16 = r.read_uint(16)
    if crc16(r.data[header_start:crc_pos]) != expected16:
        raise ValueError("FLAC frame CRC-16 mismatch")
    return frame, rate


def _split_stream(data: bytes) -> Tuple[StreamInfo, int]:
    if data[:4] != MAGIC:
        raise ValueError("not a FLAC stream")
    pos = 4
    info = None
    while True:
        header = data[pos : pos + 4]
        if len(header) < 4:
            raise ValueError("truncated FLAC metadata")
        last = header[0] & 0x80
        btype = header[0] & 0x7F
        length = int.from_bytes(header[1:4], "big")
        body = data[pos + 4 : pos + 4 + length]
        if len(body) < length:
            raise ValueError("truncated FLAC metadata")
        if btype == 0:
            try:
                info = StreamInfo(body)
            except EOFError as e:  # declared length shorter than STREAMINFO
                raise ValueError("invalid FLAC STREAMINFO block") from e
        pos += 4 + length
        if last:
            break
    if info is None:
        raise ValueError("FLAC stream missing STREAMINFO")
    return info, pos


def read(path_or_file: Union[str, os.PathLike, BinaryIO]) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file → (float32 (n, channels) in [-1, 1), sample rate)."""
    if hasattr(path_or_file, "read"):
        data = path_or_file.read()
    else:
        with open(path_or_file, "rb") as f:
            data = f.read()
    info, pos = _split_stream(data)

    r = BitReader(data[pos:])
    frames = []
    total = 0
    md5 = hashlib.md5()
    while True:
        # stop at EOF (all bits consumed up to byte alignment / padding)
        if r.byte_pos() >= len(r.data) - 1 and r.pos >= r.bits.size - 7:
            break
        if info.total_samples and total >= info.total_samples:
            break
        frame, _rate = _decode_frame(r, info)
        frames.append(frame)
        total += frame.shape[0]
        md5.update(_samples_to_le_bytes(frame, info.bits_per_sample))
        if r.pos >= r.bits.size:
            break
    if not frames:
        if info.total_samples == 0:
            # a zero-frame stream is legal when STREAMINFO says 0 samples —
            # our own write() of empty audio produces one; mirror WAV's
            # empty round-trip instead of erroring
            return (
                np.zeros((0, info.channels), dtype=np.float32),
                info.sample_rate,
            )
        raise ValueError("FLAC stream contains no audio frames")
    samples = np.concatenate(frames, axis=0)
    if info.total_samples and total < info.total_samples:
        # a stream cut at a frame boundary passes every per-frame CRC but is
        # still truncated — the MD5 check below would be silently skipped
        raise ValueError(
            f"FLAC stream truncated: expected {info.total_samples} samples, "
            f"got {total}"
        )
    if info.total_samples:
        samples = samples[: info.total_samples]
    if (
        info.md5 != b"\x00" * 16
        and total == info.total_samples
        and md5.digest() != info.md5
    ):
        raise ValueError("FLAC MD5 mismatch: stream is corrupt")
    scale = float(1 << (info.bits_per_sample - 1))
    return (samples.astype(np.float32) / scale), info.sample_rate


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def _samples_to_le_bytes(samples: np.ndarray, bps: int) -> bytes:
    """Raw little-endian sample bytes, interleaved — the STREAMINFO MD5 input."""
    nbytes = (bps + 7) // 8
    flat = samples.astype(np.int64).reshape(-1)
    out = np.empty((flat.size, nbytes), dtype=np.uint8)
    v = flat & ((1 << (8 * nbytes)) - 1)
    for b in range(nbytes):
        out[:, b] = (v >> (8 * b)) & 0xFF
    return out.tobytes()


def _best_rice_k(residuals: np.ndarray) -> Tuple[int, int]:
    """(k, bit cost) minimizing the rice-coded size of the residual block."""
    u = residuals.astype(np.int64)
    u = (u << 1) ^ (u >> 63)
    n = u.size
    if n == 0:
        return 0, 0
    mean = max(1.0, float(u.mean()))
    k0 = max(0, int(np.log2(mean)))
    best = (0, None)
    for k in range(max(0, k0 - 1), min(30, k0 + 2) + 1):
        cost = int((u >> k).sum()) + n * (1 + k)
        if best[1] is None or cost < best[1]:
            best = (k, cost)
    return best


def _fixed_residual(sig: np.ndarray, order: int) -> np.ndarray:
    res = sig.astype(np.int64)
    for _ in range(order):
        res = np.diff(res)
    return res


def _encode_subframe(w: BitWriter, sig: np.ndarray, bps: int) -> None:
    """CONSTANT if flat, else best fixed-order predictor with rice residuals."""
    if np.all(sig == sig[0]):
        w.write_uint(0, 1)
        w.write_uint(0, 6)  # CONSTANT
        w.write_uint(0, 1)  # no wasted bits
        w.write_sint(int(sig[0]), bps)
        return

    max_order = min(4, sig.size - 1)
    best_order, best_cost, best_res, best_k = 0, None, None, 0
    for order in range(0, max_order + 1):
        res = _fixed_residual(sig, order)
        if res.size and int(np.abs(res).max()) >= (1 << 62):
            continue
        k, cost = _best_rice_k(res)
        cost += order * bps
        if best_cost is None or cost < best_cost:
            best_order, best_cost, best_res, best_k = order, cost, res, k

    verbatim_cost = sig.size * bps
    if best_cost is None or best_cost >= verbatim_cost:
        w.write_uint(0, 1)
        w.write_uint(1, 6)  # VERBATIM
        w.write_uint(0, 1)
        for v in sig.tolist():
            w.write_sint(int(v), bps)
        return

    w.write_uint(0, 1)
    w.write_uint(8 + best_order, 6)  # FIXED, order
    w.write_uint(0, 1)  # no wasted bits
    for v in sig[:best_order].tolist():
        w.write_sint(int(v), bps)
    # residual: rice method 0, partition order 0 (one parameter)
    w.write_uint(0, 2)
    w.write_uint(0, 4)
    if best_k >= 15:  # escape to raw 5-bit-width storage
        w.write_uint(15, 4)
        raw_bits = max(1, int(np.abs(best_res).max()).bit_length() + 1) if best_res.size else 1
        raw_bits = min(raw_bits, 31)
        w.write_uint(raw_bits, 5)
        for v in best_res.tolist():
            w.write_sint(int(v), raw_bits)
    else:
        w.write_uint(best_k, 4)
        w.write_rice_block(best_res, best_k)


def _subframe_cost(sig: np.ndarray, bps: int) -> int:
    """Estimated bit cost of _encode_subframe for stereo-mode selection."""
    if np.all(sig == sig[0]):
        return 8 + bps
    max_order = min(4, sig.size - 1)
    best = sig.size * bps
    for order in range(0, max_order + 1):
        res = _fixed_residual(sig, order)
        k, cost = _best_rice_k(res)
        best = min(best, cost + order * bps)
    return best


def _encode_frame(frame: np.ndarray, frame_index: int, rate: int, bps: int,
                  channels: int, blocksize: int) -> bytes:
    w = BitWriter()
    w.write_uint(0b11111111111110, 14)
    w.write_uint(0, 1)
    w.write_uint(0, 1)  # fixed blocksize stream → frame numbering
    if blocksize == 192:
        bs_code, bs_extra = 1, None
    elif blocksize in (576, 1152, 2304, 4608):
        bs_code, bs_extra = 2 + (576, 1152, 2304, 4608).index(blocksize), None
    elif blocksize in (256, 512, 1024, 2048, 4096, 8192, 16384, 32768):
        bs_code, bs_extra = 8 + (256, 512, 1024, 2048, 4096, 8192, 16384, 32768).index(blocksize), None
    else:
        bs_code, bs_extra = 7, blocksize - 1
    w.write_uint(bs_code, 4)
    sr_code = _RATE_CODES.get(rate, 0)
    sr_extra = None
    if sr_code == 0 and rate != 0:
        if rate % 10 == 0 and rate // 10 < 65536:
            sr_code, sr_extra = 14, rate // 10
        elif rate < 65536:
            sr_code, sr_extra = 13, rate
    w.write_uint(sr_code, 4)

    mode = "indep"
    if channels == 2:
        left = frame[:, 0].astype(np.int64)
        right = frame[:, 1].astype(np.int64)
        side = left - right
        mid = (left + right) >> 1
        costs = {
            "indep": _subframe_cost(left, bps) + _subframe_cost(right, bps),
            "ls": _subframe_cost(left, bps) + _subframe_cost(side, bps + 1),
            "rs": _subframe_cost(side, bps + 1) + _subframe_cost(right, bps),
            "ms": _subframe_cost(mid, bps) + _subframe_cost(side, bps + 1),
        }
        mode = min(costs, key=costs.get)
    ch_code = {"indep": channels - 1, "ls": 8, "rs": 9, "ms": 10}[mode]
    w.write_uint(ch_code, 4)
    w.write_uint(_BPS_CODES.get(bps, 0), 3)
    w.write_uint(0, 1)
    w.write_utf8_number(frame_index)
    if bs_extra is not None:
        w.write_uint(bs_extra, 16)
    if sr_extra is not None:
        w.write_uint(sr_extra, 16 if sr_code in (13, 14) else 8)
    header = w.getvalue()
    header += bytes([crc8(header)])

    body = BitWriter()
    if channels == 2 and mode != "indep":
        if mode == "ls":
            body_chans = [(left, bps), (side, bps + 1)]
        elif mode == "rs":
            body_chans = [(side, bps + 1), (right, bps)]
        else:
            body_chans = [(mid, bps), (side, bps + 1)]
        for sig, cbps in body_chans:
            _encode_subframe(body, sig, cbps)
    else:
        for c in range(channels):
            _encode_subframe(body, frame[:, c].astype(np.int64), bps)
    payload = header + body.getvalue()
    return payload + crc16(payload).to_bytes(2, "big")


def write(path_or_file: Union[str, os.PathLike, BinaryIO], data: np.ndarray,
          rate: int, bits_per_sample: int = 16,
          blocksize: int = DEFAULT_BLOCK) -> None:
    """Encode float or integer samples to a FLAC file.

    Float input is quantized like the WAV writer (scale by 2^(bps−1),
    clip to the signed range); integer input is taken as-is.
    """
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, np.newaxis]
    if data.dtype.kind == "f":
        if not np.all(np.isfinite(data)):
            # NaN quantizes to INT64_MIN through the int cast and blows up
            # the residual-cost search (TypeError deep in _subframe_cost) —
            # reject with the clean-ValueError error contract instead
            # (found by tools/fuzz_campaign.py encode mode)
            raise ValueError("cannot encode non-finite samples (NaN/Inf) to FLAC")
        scale = 1 << (bits_per_sample - 1)
        samples = np.clip(np.round(data * scale), -scale, scale - 1).astype(np.int64)
    else:
        samples = data.astype(np.int64)
        lim = 1 << (bits_per_sample - 1)
        if samples.size and (samples.min() < -lim or samples.max() >= lim):
            # write_sint would silently wrap, and the STREAMINFO MD5 is
            # computed over the unwrapped values — the file would both
            # decode to wrong audio and fail its own integrity check
            raise ValueError(
                f"integer samples exceed the {bits_per_sample}-bit range"
            )
    n, channels = samples.shape
    if not 1 <= channels <= 8:
        raise ValueError(f"FLAC supports 1-8 channels, got {channels}")
    if bits_per_sample not in (8, 12, 16, 20, 24):
        raise ValueError(f"unsupported bits per sample {bits_per_sample}")
    if not 16 <= blocksize <= 65535:
        # STREAMINFO stores the blocksize in 16 bits; write_uint would
        # silently mask a larger value into a corrupt header
        raise ValueError(f"FLAC blocksize must be in [16, 65535], got {blocksize}")
    if not 1 <= int(rate) < (1 << 20):
        # STREAMINFO stores the rate in 20 bits — the same silent-mask
        # hazard as the blocksize (a >= 2^20 Hz rate would write a valid
        # file at the WRONG pitch/duration)
        raise ValueError(f"FLAC sample rate must be in [1, 1048575], got {rate}")

    md5 = hashlib.md5(_samples_to_le_bytes(samples, bits_per_sample))
    frames = []
    for idx, lo in enumerate(range(0, n, blocksize)):
        chunk = samples[lo : lo + blocksize]
        frames.append(
            _encode_frame(chunk, idx, rate, bits_per_sample, channels, chunk.shape[0])
        )
    frame_sizes = [len(f) for f in frames] or [0]

    si = BitWriter()
    # min == max marks a fixed-blocksize stream (the last block may be
    # shorter and is excluded from the min by spec)
    si.write_uint(blocksize, 16)
    si.write_uint(blocksize, 16)
    si.write_uint(min(frame_sizes), 24)
    si.write_uint(max(frame_sizes), 24)
    si.write_uint(rate, 20)
    si.write_uint(channels - 1, 3)
    si.write_uint(bits_per_sample - 1, 5)
    si.write_uint(n, 36)
    streaminfo = si.getvalue() + md5.digest()

    out = bytearray()
    out += MAGIC
    out += bytes([0x80 | 0x00]) + len(streaminfo).to_bytes(3, "big")
    out += streaminfo
    for f in frames:
        out += f

    if hasattr(path_or_file, "write"):
        path_or_file.write(bytes(out))
    else:
        with open(path_or_file, "wb") as fh:
            fh.write(bytes(out))


def probe(path: Union[str, os.PathLike]) -> dict:
    """Header-only metadata (same dict shape as wavio.probe).

    Reads 64 KiB and doubles on demand — the metadata chain can exceed the
    initial window (e.g. multi-hundred-KiB embedded PICTURE blocks) without
    pulling the whole audio stream in.
    """
    with open(path, "rb") as f:
        data = f.read(64 * 1024)
        while True:
            try:
                info, _pos = _split_stream(data)
                break
            except ValueError as e:
                if "truncated FLAC metadata" not in str(e):
                    raise
                more = f.read(max(len(data), 64 * 1024))
                if not more:
                    raise
                data += more
    return {
        "samplerate": info.sample_rate,
        "channels": info.channels,
        "bits": info.bits_per_sample,
        "frames": info.total_samples,
        "duration": (
            info.total_samples / info.sample_rate if info.sample_rate else 0.0
        ),
    }
