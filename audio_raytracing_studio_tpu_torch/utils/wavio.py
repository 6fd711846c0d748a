"""Audio I/O — the port's own copy of ``audio_raytracing_studio_tpu/utils/
wavio.py`` (host code, no device work).

- read: WAV PCM 8/16/24/32-bit and IEEE float32/64, plain and
  WAVE_FORMAT_EXTENSIBLE headers; AIFF / AIFC PCM ('NONE', 'sowt') and
  'fl32'; FLAC (``flacio``); Ogg/Vorbis (``lavcio`` first, then
  ``vorbisio``); MP3 (``mp3io``, libmpg123); AAC / M4A and whatever else
  libavformat demuxes (``lavcio``); then soundfile and the ffmpeg binary
  where present.  Returns float32, always 2-D (samples, channels), like
  ``sf.read(dtype='float32', always_2d=True)``.
- write: WAV PCM_16 (libsndfile's ×32768 / round-half-even conversion) or
  FLOAT, an EXTENSIBLE header for more than two channels; ``write_audio``
  dispatches .flac / .ogg / .mp3 / .aac / .m4a / .mp4 to their encoders.
- probe / info: header-only rate / channels / bits / frames.

PCM16 conversion runs in the C++ loop of ``_native/pcm_codec.cc`` (built at
first use by ``kernels.build_host``) where g++ can build it, else in NumPy,
to the same bits.  ``warm_native`` builds every host library of the codecs
up front, so a server or a timed run does not pay for g++ in its first call.
"""

from __future__ import annotations

import io
import os
import struct
import time
from typing import BinaryIO, Tuple, Union

import numpy as np

from . import _native_pcm as _npcm

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

# output extensions of the compressed encoders (``write_audio``)
COMPRESSED_EXTENSIONS = (".flac", ".ogg", ".mp3", ".aac", ".m4a", ".mp4")


def warm_native() -> dict:
    """Build (or find) the codecs' host libraries now: the native PCM16,
    FLAC and Vorbis loops and the FFmpeg shim.  Returns, per library, whether
    it is available and the seconds this call spent on it.  A library that
    cannot build leaves its NumPy or next-tier path in place."""
    from . import _native_flac, _native_vorbis, lavcio

    out = {}
    for name, available in (("pcm", _npcm.available), ("flac", _native_flac.available),
                            ("vorbis", _native_vorbis.available),
                            ("lavc", lavcio.decode_available)):
        t0 = time.perf_counter()
        out[name] = {"available": available(), "s": time.perf_counter() - t0}
    return out


def encode_pcm16(x: np.ndarray) -> np.ndarray:
    """float → int16 with libsndfile semantics: ×32768 in float32,
    round-half-even (lrintf), saturate."""
    if _npcm.available():
        return _npcm.encode_pcm16(np.ascontiguousarray(x, dtype=np.float32))
    scaled = np.rint(np.asarray(x, dtype=np.float32) * np.float32(32768.0))
    return np.clip(scaled, -32768, 32767).astype(np.int16)


def decode_pcm16(raw: np.ndarray) -> np.ndarray:
    """int16 → float32 with libsndfile semantics: ÷32768."""
    if _npcm.available():
        return _npcm.decode_pcm16(np.ascontiguousarray(raw))
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


def _decode_via_ffmpeg(path: Union[str, os.PathLike]) -> Tuple[np.ndarray, int]:
    """Decode any ffmpeg-supported file to float32 WAV via a temp file."""
    import subprocess
    import tempfile

    fd, tmp = tempfile.mkstemp(suffix=".wav", prefix="ars_decode_")
    os.close(fd)
    try:
        proc = subprocess.run(
            ["ffmpeg", "-y", "-v", "error", "-i", str(path),
             "-acodec", "pcm_f32le", "-f", "wav", tmp],
            capture_output=True,
        )
        if proc.returncode != 0:
            raise ValueError(
                f"ffmpeg konnte die Datei nicht dekodieren: "
                f"{proc.stderr.decode('utf-8', 'replace').strip()[:300]}"
            )
        with open(tmp, "rb") as fh:
            return _read_stream(fh)
    finally:
        try:
            os.remove(tmp)
        except OSError:
            pass


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
        raise ValueError(
            f"unsupported AIFC compression {comp!r} — only PCM ('NONE'/'sowt') "
            "and 'fl32' are supported natively; install ffmpeg for others"
        )
    usable = (data.shape[0] // channels) * channels
    data = data[:usable]
    if frames > 0:
        # honor the COMM frame count: trailing SSND slack/pad bytes are not audio
        data = data[: frames * channels]
    return data.reshape(-1, channels), int(round(rate))


def _read_nonwav(path: Union[str, os.PathLike], container: str) -> Tuple[np.ndarray, int]:
    """Non-WAV inputs: FLAC/AIFF/Ogg via the in-repo codecs, MP3 via the
    system libmpg123 (ctypes), AAC/M4A — and anything the in-repo decoders
    decline — via the FFmpeg *libraries* (utils/lavcio, a compiled shim; no
    binary), else soundfile if importable, else the ffmpeg binary, else a
    clear user-facing error (the reference reads FLAC/OGG via soundfile,
    everything else via FFmpeg).  The tiers and their error strings are the
    JAX package's, in its order."""
    if container == "FLAC":
        from . import flacio

        try:
            data, rate = flacio.read(path)
        except EOFError as e:  # truncated stream → same error contract
            raise ValueError(f"FLAC-Datei beschädigt oder abgeschnitten: {e}")
        return np.asarray(data, dtype=np.float32), int(rate)
    if container == "AIFF":
        try:
            return _read_aiff(path)
        except ValueError as e:
            if "unsupported AIFC compression" not in str(e):
                raise
            # compressed AIFC → fall through to soundfile/ffmpeg below
    if container == "OGG/Vorbis":
        from . import lavcio, vorbisio

        if lavcio.decode_available():
            # fast C tier first: libavcodec decodes Vorbis far faster than
            # the in-repo decoder (tools/bench_codecs.py measures both),
            # which matters because uploads decode on the serving HTTP
            # thread.  Channel order
            # agrees since vorbisenc/vorbisio speak spec order on the wire
            # (vorbisio.WAV_FROM_VORBIS).  Any failure falls through to the
            # native decoder, which keeps the precise error contract and
            # stays the spec oracle (cross-validated in tests/test_vorbisio).
            try:
                data, rate = lavcio.decode(path)
                return np.asarray(data, dtype=np.float32), int(rate)
            except ValueError:
                pass
        try:
            data, rate = vorbisio.decode(path)
            return np.asarray(data, dtype=np.float32), int(rate)
        except vorbisio.UnsupportedCodec:
            # legal Ogg, non-native payload (Opus, Ogg/FLAC, Speex, floor-0
            # Vorbis …) → fall through to the universal/soundfile/ffmpeg tiers
            pass
        except ValueError as e:
            raise ValueError(f"OGG-Datei beschädigt oder abgeschnitten: {e}")
    if container == "MP3":
        from . import mp3io

        if mp3io.decode_available():
            # libmpg123 bound directly (all MPEG layers); decode errors are
            # terminal — EXCEPT for ID3-prefixed files: taggers prepend
            # ID3v2 to any container (FLAC included), so an "MP3" sniffed
            # only off its tag may not be MPEG audio at all — let the
            # universal lavc tier inspect the real payload instead
            try:
                with open(path, "rb") as fh:
                    id3_prefixed = fh.read(3) == b"ID3"
            except OSError:
                id3_prefixed = False
            try:
                data, rate = mp3io.decode(path)
                return np.asarray(data, dtype=np.float32), int(rate)
            except ValueError as e:
                if not id3_prefixed:
                    raise ValueError(
                        f"MP3-Datei beschädigt oder abgeschnitten: {e}"
                    )
    from . import lavcio

    if container in ("AAC", "MP4/M4A"):
        if lavcio.decode_available():
            # FFmpeg libraries bound directly; decode errors are terminal —
            # only library absence falls through to the tiers below
            try:
                data, rate = lavcio.decode(path)
                return np.asarray(data, dtype=np.float32), int(rate)
            except ValueError as e:
                raise ValueError(
                    f"{container}-Datei beschädigt oder nicht dekodierbar: {e}"
                )
    elif lavcio.decode_available():
        # universal library tier for whatever the native decoders declined
        # (compressed AIFC, Opus-in-Ogg, floor-0 Vorbis, WMA …); failures
        # here keep the soundfile/ffmpeg tiers' error contract
        try:
            data, rate = lavcio.decode(path)
            return np.asarray(data, dtype=np.float32), int(rate)
        except ValueError:
            pass
    try:  # optional, not in the base image
        import soundfile as sf  # type: ignore

        data, rate = sf.read(str(path), dtype="float32", always_2d=True)
        return np.asarray(data, dtype=np.float32), int(rate)
    except (ImportError, OSError):
        # OSError: the package imports but libsndfile.so is absent —
        # fall through to ffmpeg rather than leaking a linker error
        pass
    import shutil

    if shutil.which("ffmpeg") is not None:
        return _decode_via_ffmpeg(path)
    raise ValueError(
        f"{container}-Eingabe wird nativ nicht unterstützt und ffmpeg wurde "
        f"nicht gefunden. Bitte die Datei als WAV bereitstellen oder ffmpeg "
        f"installieren (wie beim Referenz-Studio: FFmpeg-Abhängigkeit für "
        f"Nicht-WAV-Formate)."
    )


def read(path_or_file: Union[str, os.PathLike, BinaryIO]) -> Tuple[np.ndarray, int]:
    """Read an audio file → (float32 array of shape (samples, channels), rate).

    WAV/FLAC/AIFF/OGG decode in-repo, MP3 through the system libmpg123,
    AAC/M4A (and anything else libavformat can demux) through the FFmpeg
    libraries bound in-process (utils/lavcio — no ffmpeg binary); only
    when every tier is absent does a clear install-ffmpeg error surface
    (reference: sf.read at raytracer_studio.py:1013, FFmpeg note at
    :1396).  File-like inputs must be WAV.
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
    return _checked_rate(_read_nonwav(path_or_file, container))


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
    """Extension-dispatching writer: ``.flac`` → the in-repo FLAC encoder,
    ``.ogg`` → the in-repo Vorbis encoder, ``.mp3`` → libmp3lame (utils/
    mp3io, ≤2 channels), ``.aac``/``.m4a``/``.mp4`` → the FFmpeg
    libraries' AAC-LC encoder (utils/lavcio), anything else → WAV.  Lets
    every CLI accept compressed output targets (the reference can only
    write WAV, raytracer_studio.py:1084; FLAC halves the file at
    bit-identical 16-bit fidelity, Ogg/Vorbis/MP3/AAC compress further,
    lossily).  ``subtype`` applies to the PCM containers ("PCM_16" →
    16-bit, "FLOAT"/"PCM_24" → 24-bit FLAC); the lossy encoders are float
    end to end.
    """
    lower = str(path).lower()
    if np.asarray(data).dtype == np.int16 and lower.endswith(COMPRESSED_EXTENSIONS):
        # compressed encoders are float end-to-end; ÷32768 is exactly
        # invertible for every int16 value, so a device-quantized PCM16
        # buffer loses nothing on the way in
        data = decode_pcm16(np.asarray(data))
    if lower.endswith(".flac"):
        from . import flacio

        bits = 16 if subtype == "PCM_16" else 24
        flacio.write(path, data, rate, bits_per_sample=bits)
        return
    if lower.endswith(".ogg"):
        from . import vorbisenc

        vorbisenc.write(path, data, rate)
        return
    if lower.endswith(".mp3"):
        from . import mp3io

        mp3io.write(path, data, rate)
        return
    if lower.endswith((".aac", ".m4a", ".mp4")):
        from . import lavcio

        lavcio.encode_aac(path, data, rate)
        return
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
            f"WAV cannot hold {total} bytes (4 GiB RIFF limit) — "
            "write FLAC instead or split the render"
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
        if header[:4] == MAGIC_FLAC:
            from . import flacio

            return flacio.probe(path)
        if header[:4] == b"FORM" and header[8:12] in (b"AIFF", b"AIFC"):
            return _probe_aiff(path)
        if header[:4] == b"OggS":
            from . import vorbisio

            meta = vorbisio.probe(path)
            meta.setdefault("bits", 0)  # lossy: no PCM bit depth
            return meta
        if sniff_container(header) == "MP3":
            from . import mp3io

            if not mp3io.decode_available():
                raise ValueError(
                    "MP3-Probe benötigt libmpg123 (nicht vorhanden)"
                )
            return mp3io.probe(path)
        if sniff_container(header) in ("AAC", "MP4/M4A"):
            from . import lavcio

            if not lavcio.decode_available():
                raise ValueError(
                    "AAC/M4A-Probe benötigt die FFmpeg-Bibliotheken "
                    "(nicht vorhanden)"
                )
            return lavcio.probe(path)
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


def info(path: Union[str, os.PathLike]) -> dict:
    """Basic file info: rate, channels, frames, duration (analyser.py:50-58).

    Delegates to the header-only ``probe`` — decoding a whole clip to read
    four header fields would cost hundreds of MB on an hour-long file.
    Falls back to a full decode only where probe cannot help but read can
    (e.g. the ffmpeg-binary tier for formats the native probes don't cover).
    """
    try:
        meta = probe(path)
        rate, frames = meta["samplerate"], meta["frames"]
        channels = meta["channels"]
    except (OSError, ValueError):
        data, rate = read(path)
        frames, channels = data.shape[0], data.shape[1]
    return {
        "samplerate": rate,
        "channels": channels,
        "frames": frames,
        "duration": frames / rate if rate > 0 else 0.0,
    }
