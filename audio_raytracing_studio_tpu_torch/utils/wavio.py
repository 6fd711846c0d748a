"""WAV and AIFF audio I/O — the port's own copy of the RIFF/WAVE and AIFF
parts of ``audio_raytracing_studio_tpu/utils/wavio.py`` (pure NumPy, no
device work).

- read: WAV PCM 8/16/24/32-bit and IEEE float32/64, plain and
  WAVE_FORMAT_EXTENSIBLE headers; AIFF / AIFC PCM ('NONE', 'sowt') and
  'fl32'.  Returns float32, always 2-D (samples, channels), like
  ``sf.read(dtype='float32', always_2d=True)``.
- write: WAV PCM_16 (libsndfile's ×32768 / round-half-even conversion) or
  FLOAT; an EXTENSIBLE header for more than two channels.
- probe: header-only rate / channels / bits / frames of a WAV or AIFF file.

FLAC, Ogg, MP3, AAC and M4A are not read or written by the port yet: they
raise ``ValueError`` (the CLIs report it as ``error: …``).
"""

from __future__ import annotations

import io
import os
import struct
from typing import BinaryIO, Tuple, Union

import numpy as np

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_EXTENSIBLE = 0xFFFE

# Standard channel masks for the layouts we emit.
_CHANNEL_MASKS = {
    1: 0x4,  # FC
    2: 0x3,  # FL FR
    6: 0x3F,  # FL FR FC LFE BL BR
    8: 0x63F,  # FL FR FC LFE BL BR SL SR
}

# output extensions of the JAX package's compressed encoders
COMPRESSED_EXTENSIONS = (".flac", ".ogg", ".mp3", ".aac", ".m4a", ".mp4")


def not_supported(container: str) -> ValueError:
    return ValueError(
        f"{container} is not supported by the PyTorch port yet: it reads WAV "
        "and AIFF and writes WAV"
    )


def encode_pcm16(x: np.ndarray) -> np.ndarray:
    """float → int16 with libsndfile semantics: ×32768 in float32,
    round-half-even (lrintf), saturate."""
    scaled = np.rint(np.asarray(x, dtype=np.float32) * np.float32(32768.0))
    return np.clip(scaled, -32768, 32767).astype(np.int16)


def decode_pcm16(raw: np.ndarray) -> np.ndarray:
    """int16 → float32 with libsndfile semantics: ÷32768."""
    return (raw.astype(np.float32)) / 32768.0


def _decode_pcm24(raw: bytes, num_values: int) -> np.ndarray:
    b = np.frombuffer(raw, dtype=np.uint8).reshape(num_values, 3)
    as_int = (
        b[:, 0].astype(np.int32)
        | (b[:, 1].astype(np.int32) << 8)
        | (b[:, 2].astype(np.int32) << 16)
    )
    as_int = np.where(as_int >= 0x800000, as_int - 0x1000000, as_int)
    return as_int.astype(np.float32) / 8388608.0


MAGIC_FLAC = b"fLaC"
_CONTAINER_SIGNATURES: Tuple[Tuple[bytes, str], ...] = (
    (MAGIC_FLAC, "FLAC"),
    (b"OggS", "OGG/Vorbis"),
    (b"ID3", "MP3"),
    (b"\xff\xfb", "MP3"),
    (b"\xff\xf3", "MP3"),
    (b"\xff\xf2", "MP3"),
    (b"\xff\xf1", "AAC"),
    (b"\xff\xf9", "AAC"),
)


def sniff_container(head: bytes) -> Union[str, None]:
    """Best-effort container name from the first bytes (None if unknown)."""
    if len(head) >= 12 and head[:4] == b"RIFF" and head[8:12] == b"WAVE":
        return "WAV"
    if len(head) >= 12 and head[4:8] == b"ftyp":
        return "MP4/M4A"
    if len(head) >= 12 and head[:4] == b"FORM" and head[8:12] in (b"AIFF", b"AIFC"):
        return "AIFF"
    for magic, name in _CONTAINER_SIGNATURES:
        if head.startswith(magic):
            return name
    # generic MPEG audio frame sync (0xFF + top 3 bits of byte 1), validated
    # past the bare sync: the version bits must not be the reserved pattern,
    # and for MP3 the bitrate nibble (0xF) and sample-rate bits (0b11) must
    # be legal
    if len(head) >= 4 and head[0] == 0xFF and (head[1] & 0xE0) == 0xE0:
        version_bits = (head[1] >> 3) & 0x3
        layer_bits = (head[1] >> 1) & 0x3
        if version_bits == 1:  # reserved MPEG version
            return None
        if layer_bits == 0:  # layer 00: ADTS AAC framing
            if (head[1] & 0xF0) == 0xF0 and ((head[2] >> 2) & 0xF) < 13:
                return "AAC"
            return None
        bitrate_nibble = head[2] >> 4
        samplerate_bits = (head[2] >> 2) & 0x3
        if bitrate_nibble == 0xF or samplerate_bits == 3:
            return None
        return "MP3"
    return None


def _read_f80(raw: bytes) -> float:
    """80-bit IEEE 754 extended float (AIFF COMM sample rate), big-endian."""
    if len(raw) < 10:
        raise ValueError("truncated AIFF extended float")
    sign = -1.0 if raw[0] & 0x80 else 1.0
    exponent = ((raw[0] & 0x7F) << 8) | raw[1]
    mantissa = int.from_bytes(raw[2:10], "big")
    if exponent == 0 and mantissa == 0:
        return 0.0
    if exponent - 16383 - 63 > 1024:
        # 2.0**e would raise OverflowError, not ValueError
        raise ValueError("invalid AIFF extended-float sample rate")
    return sign * mantissa * 2.0 ** (exponent - 16383 - 63)


def _read_aiff(path: Union[str, os.PathLike]) -> Tuple[np.ndarray, int]:
    """AIFF / AIFC reader: big-endian PCM 8/16/24/32 ('NONE') plus the
    little-endian AIFC variant ('sowt') and 'fl32'/'FL32' float."""
    with open(path, "rb") as fh:
        head = fh.read(12)
        if len(head) < 12 or head[:4] != b"FORM" or head[8:12] not in (b"AIFF", b"AIFC"):
            raise ValueError("not an AIFF/AIFC file")
        is_aifc = head[8:12] == b"AIFC"
        comm = None
        ssnd = None
        comp = b"NONE"
        while True:
            ch = fh.read(8)
            if len(ch) < 8:
                break
            cid, csize = ch[:4], int.from_bytes(ch[4:8], "big")
            body = fh.read(csize)
            if len(body) < csize:
                raise ValueError("corrupt or truncated AIFF chunk")
            if csize & 1:
                fh.seek(1, io.SEEK_CUR)
            if cid == b"COMM":
                if len(body) < 18:
                    raise ValueError("corrupt or truncated AIFF COMM chunk")
                channels = int.from_bytes(body[0:2], "big")
                frames = int.from_bytes(body[2:6], "big")
                bits = int.from_bytes(body[6:8], "big")
                rate = _read_f80(body[8:18])
                if is_aifc and len(body) >= 22:
                    comp = body[18:22]
                comm = (channels, frames, bits, rate)
            elif cid == b"SSND":
                if len(body) < 8:
                    raise ValueError("corrupt or truncated AIFF SSND chunk")
                offset = int.from_bytes(body[0:4], "big")
                ssnd = body[8 + offset :]
        if comm is None or ssnd is None:
            raise ValueError("AIFF file missing COMM or SSND chunk")
    channels, frames, bits, rate = comm
    if channels <= 0 or rate <= 0:
        raise ValueError("invalid AIFF header")
    if comp in (b"fl32", b"FL32"):
        data = np.frombuffer(ssnd, dtype=">f4").astype(np.float32)
    elif comp in (b"NONE", b"sowt"):
        endian = "<" if comp == b"sowt" else ">"
        if bits == 8:  # AIFF 8-bit is SIGNED (unlike WAV's unsigned)
            data = np.frombuffer(ssnd, dtype=np.int8).astype(np.float32) / 128.0
        elif bits == 16:
            data = np.frombuffer(ssnd, dtype=f"{endian}i2").astype(np.float32) / 32768.0
        elif bits == 24:
            usable24 = (len(ssnd) // 3) * 3
            if comp == b"sowt":  # little-endian: the one shared 24-bit decoder
                data = _decode_pcm24(ssnd[:usable24], usable24 // 3)
            else:  # big-endian: reverse the byte order per sample, then share
                b3 = np.frombuffer(ssnd[:usable24], dtype=np.uint8).reshape(-1, 3)
                data = _decode_pcm24(b3[:, ::-1].tobytes(), usable24 // 3)
        elif bits == 32:
            data = np.frombuffer(ssnd, dtype=f"{endian}i4").astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"unsupported AIFF bit depth {bits}")
    else:
        raise not_supported(f"compressed AIFC ({comp!r})")
    usable = (data.shape[0] // channels) * channels
    data = data[:usable]
    if frames > 0:
        # honor the COMM frame count: trailing SSND slack/pad bytes are not audio
        data = data[: frames * channels]
    return data.reshape(-1, channels), int(round(rate))


def read(path_or_file: Union[str, os.PathLike, BinaryIO]) -> Tuple[np.ndarray, int]:
    """Read a WAV or AIFF file → (float32 array (samples, channels), rate).

    File-like inputs must be WAV.  Other containers raise ``ValueError``.
    """
    if hasattr(path_or_file, "read"):
        return _checked_rate(_read_stream(path_or_file))
    with open(path_or_file, "rb") as fh:
        head = fh.read(12)
        container = sniff_container(head)
        if container == "WAV" or container is None:
            # unknown bytes still go to the WAV parser for its error message
            fh.seek(0)
            return _checked_rate(_read_stream(fh))
    if container != "AIFF":
        raise not_supported(f"{container} input")
    return _checked_rate(_read_aiff(path_or_file))


# Highest sample rate any real-world audio format uses (DSD64).  A crafted
# header rate above it is corruption, not audio: the rate flows into IR
# sizing (~10 s · rate samples), so it is refused at the boundary.
MAX_SAMPLE_RATE = 2_822_400


def _rate_error(rate: int) -> ValueError:
    return ValueError(
        f"implausible sample rate {rate} Hz (limit {MAX_SAMPLE_RATE}); "
        "the file header is corrupt or crafted"
    )


def _checked_rate(result: Tuple[np.ndarray, int]) -> Tuple[np.ndarray, int]:
    data, rate = result
    if not (0 < rate <= MAX_SAMPLE_RATE):
        raise _rate_error(rate)
    return data, rate


def _read_stream(fh: BinaryIO) -> Tuple[np.ndarray, int]:
    try:
        return _read_stream_impl(fh)
    except struct.error as e:  # undersized/truncated chunk → error contract
        raise ValueError(f"corrupt or truncated WAV header: {e}") from e


def _read_stream_impl(fh: BinaryIO) -> Tuple[np.ndarray, int]:
    header = fh.read(12)
    if len(header) < 12 or header[:4] != b"RIFF" or header[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")

    fmt = None
    data_bytes = None
    while True:
        chunk_header = fh.read(8)
        if len(chunk_header) < 8:
            break
        chunk_id, chunk_size = struct.unpack("<4sI", chunk_header)
        if chunk_id == b"fmt ":
            fmt_raw = fh.read(chunk_size)
            if chunk_size & 1:
                fh.seek(1, io.SEEK_CUR)  # RIFF pad byte
            (
                audio_format,
                channels,
                rate,
                _byte_rate,
                _block_align,
                bits,
            ) = struct.unpack("<HHIIHH", fmt_raw[:16])
            if audio_format == WAVE_FORMAT_EXTENSIBLE and chunk_size >= 40:
                # sub-format GUID's first two bytes carry the real format tag
                audio_format = struct.unpack("<H", fmt_raw[24:26])[0]
            fmt = (audio_format, channels, rate, bits)
        elif chunk_id == b"data":
            data_bytes = fh.read(chunk_size)
            if chunk_size & 1:
                fh.seek(1, io.SEEK_CUR)  # RIFF pad byte
        else:
            fh.seek(chunk_size + (chunk_size & 1), io.SEEK_CUR)
        if fmt is not None and data_bytes is not None:
            break

    if fmt is None or data_bytes is None:
        raise ValueError("WAV file missing fmt or data chunk")
    audio_format, channels, rate, bits = fmt
    if channels <= 0:
        raise ValueError("WAV file reports zero channels")

    if audio_format == WAVE_FORMAT_PCM and bits == 16:
        data = decode_pcm16(np.frombuffer(data_bytes, dtype="<i2"))
    elif audio_format == WAVE_FORMAT_PCM and bits == 24:
        usable = (len(data_bytes) // 3) * 3
        data = _decode_pcm24(data_bytes[:usable], usable // 3)
    elif audio_format == WAVE_FORMAT_PCM and bits == 32:
        values = np.frombuffer(data_bytes, dtype="<i4")
        data = values.astype(np.float32) / 2147483648.0
    elif audio_format == WAVE_FORMAT_PCM and bits == 8:
        values = np.frombuffer(data_bytes, dtype=np.uint8)
        data = (values.astype(np.float32) - 128.0) / 128.0
    elif audio_format == WAVE_FORMAT_IEEE_FLOAT and bits == 32:
        data = np.frombuffer(data_bytes, dtype="<f4").astype(np.float32)
    elif audio_format == WAVE_FORMAT_IEEE_FLOAT and bits == 64:
        data = np.frombuffer(data_bytes, dtype="<f8").astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV format: tag={audio_format}, bits={bits}")

    frames = data.shape[0] // channels
    return data[: frames * channels].reshape(frames, channels), int(rate)


def write_audio(
    path: Union[str, os.PathLike],
    data: np.ndarray,
    rate: int,
    subtype: str = "PCM_16",
) -> None:
    """Write by extension, as the JAX package's ``write_audio`` does: the
    compressed containers (.flac, .ogg, .mp3, .aac, .m4a, .mp4) raise
    ``ValueError`` — the port has no encoder for them yet — and anything else
    is written as WAV."""
    lower = str(path).lower()
    if lower.endswith(COMPRESSED_EXTENSIONS):
        raise not_supported(f"{os.path.splitext(lower)[1]} output")
    write(path, data, rate, subtype=subtype)


def write(
    path_or_file: Union[str, os.PathLike, BinaryIO],
    data: np.ndarray,
    rate: int,
    subtype: str = "PCM_16",
) -> None:
    """Write a WAV file. ``data`` is (samples,) or (samples, channels) float —
    or int16, taken as already-quantized PCM16 samples (``pcm16_output`` of
    ``render_batch``: the same bits as ``encode_pcm16`` of the float output).

    subtype: "PCM_16" (default output contract) or "FLOAT".
    """
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, np.newaxis]
    frames, channels = data.shape

    if data.dtype == np.int16 and subtype == "FLOAT":
        data = decode_pcm16(data)
    if subtype == "PCM_16":
        payload = (
            data.astype("<i2").tobytes()
            if data.dtype == np.int16
            else encode_pcm16(data).astype("<i2").tobytes()
        )
        bits = 16
        fmt_tag = WAVE_FORMAT_PCM
    elif subtype == "FLOAT":
        payload = data.astype("<f4").tobytes()
        bits = 32
        fmt_tag = WAVE_FORMAT_IEEE_FLOAT
    else:
        raise ValueError(f"unsupported subtype: {subtype}")

    block_align = channels * bits // 8
    byte_rate = rate * block_align

    if channels > 2:
        mask = _CHANNEL_MASKS.get(channels, (1 << channels) - 1)
        fmt_chunk = struct.pack(
            "<HHIIHHHHI",
            WAVE_FORMAT_EXTENSIBLE,
            channels,
            rate,
            byte_rate,
            block_align,
            bits,
            22,  # cbSize
            bits,  # valid bits per sample
            mask,
        ) + struct.pack("<H", fmt_tag) + b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"
    else:
        fmt_chunk = struct.pack(
            "<HHIIHH", fmt_tag, channels, rate, byte_rate, block_align, bits
        )
        if fmt_tag == WAVE_FORMAT_IEEE_FLOAT:
            fmt_chunk += struct.pack("<H", 0)  # cbSize=0 for float fmt

    chunks = [(b"fmt ", fmt_chunk)]
    if fmt_tag == WAVE_FORMAT_IEEE_FLOAT:
        chunks.append((b"fact", struct.pack("<I", frames)))
    chunks.append((b"data", payload))

    total = 4 + sum(8 + len(c) + (len(c) & 1) for _, c in chunks)
    if total > 0xFFFFFFFF:
        # RIFF sizes are 32-bit; fail BEFORE open() truncates an existing file
        raise ValueError(
            f"WAV cannot hold {total} bytes (4 GiB RIFF limit) — split the render"
        )

    if hasattr(path_or_file, "write"):
        fh = path_or_file
        close = False
    else:
        fh = open(path_or_file, "wb")
        close = True
    try:
        fh.write(b"RIFF" + struct.pack("<I", total) + b"WAVE")
        for cid, c in chunks:
            fh.write(cid + struct.pack("<I", len(c)))
            fh.write(c)
            if len(c) & 1:
                fh.write(b"\x00")
    finally:
        if close:
            fh.close()


def _probe_aiff(path: Union[str, os.PathLike]) -> dict:
    """Header-only AIFF/AIFC info: seek over chunks, parse COMM only."""
    with open(path, "rb") as fh:
        fh.read(12)
        while True:
            ch = fh.read(8)
            if len(ch) < 8:
                raise ValueError("AIFF file missing COMM chunk")
            cid, csize = ch[:4], int.from_bytes(ch[4:8], "big")
            if cid == b"COMM":
                body = fh.read(min(csize, 18))
                if len(body) < 18:
                    raise ValueError("corrupt or truncated AIFF COMM chunk")
                channels = int.from_bytes(body[0:2], "big")
                frames = int.from_bytes(body[2:6], "big")
                bits = int.from_bytes(body[6:8], "big")
                rate = _read_f80(body[8:18])
                if channels <= 0 or rate <= 0:
                    raise ValueError("invalid AIFF header")
                return {
                    "samplerate": int(round(rate)),
                    "channels": channels,
                    "bits": bits,
                    "frames": frames,
                    "duration": frames / rate if rate > 0 else 0.0,
                }
            fh.seek(csize + (csize & 1), io.SEEK_CUR)


def probe(path: Union[str, os.PathLike]) -> dict:
    """Header-only info (rate, channels, bits, frames) — no sample data read,
    with ``read``'s sample-rate gate (the directory renderer buckets clips on
    it)."""
    meta = _probe_impl(path)
    rate = int(meta.get("samplerate", 0))
    if not (0 < rate <= MAX_SAMPLE_RATE):
        raise _rate_error(rate)
    return meta


def _probe_impl(path: Union[str, os.PathLike]) -> dict:
    with open(path, "rb") as fh:
        header = fh.read(12)
        if header[:4] == b"FORM" and header[8:12] in (b"AIFF", b"AIFC"):
            return _probe_aiff(path)
        container = sniff_container(header)
        if container not in ("WAV", None):
            raise not_supported(f"{container} input")
        if len(header) < 12 or header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise ValueError("not a RIFF/WAVE file")
        fmt = None
        data_size = None
        try:
            while fmt is None or data_size is None:
                chunk_header = fh.read(8)
                if len(chunk_header) < 8:
                    break
                chunk_id, chunk_size = struct.unpack("<4sI", chunk_header)
                if chunk_id == b"fmt ":
                    fmt_raw = fh.read(chunk_size)
                    if chunk_size & 1:
                        fh.seek(1, io.SEEK_CUR)
                    _tag, channels, rate, _br, _ba, bits = struct.unpack(
                        "<HHIIHH", fmt_raw[:16]
                    )
                    fmt = (channels, rate, bits)
                elif chunk_id == b"data":
                    data_size = chunk_size
                    fh.seek(chunk_size + (chunk_size & 1), io.SEEK_CUR)
                else:
                    fh.seek(chunk_size + (chunk_size & 1), io.SEEK_CUR)
        except struct.error as e:  # truncated fmt chunk → error contract
            raise ValueError(f"corrupt or truncated WAV header: {e}") from e
    if fmt is None or data_size is None:
        raise ValueError("WAV file missing fmt or data chunk")
    channels, rate, bits = fmt
    if channels <= 0 or bits <= 0:
        raise ValueError("invalid WAV header")
    frames = data_size // (channels * max(1, bits // 8))
    return {
        "samplerate": int(rate),
        "channels": int(channels),
        "bits": int(bits),
        "frames": int(frames),
        "duration": frames / rate if rate > 0 else 0.0,
    }
