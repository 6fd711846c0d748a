"""The port's lossless codecs and host libraries against the JAX package's,
on the CPU: ``utils/flacio`` (with ``_native_flac``), the PCM16 loop
(``_native_pcm``) and ``wavio``'s dispatch, and ``kernels.build_host``.

For every case the same seeded input goes through both packages: the port's
encoded bytes equal the JAX package's, each package decodes the other's
file to the same samples bit for bit, corrupt and truncated files raise the
same exception class with the same message, ``probe`` and ``info`` agree,
and the native loops give the same bytes as the NumPy paths.  The
known-answer checks of the JAX suite that need no second implementation
(the FLAC CRCs, a frame header parsed by hand) run on the port's code.
"""

import hashlib
import io
import threading
import time

import numpy as np
import pytest

from audio_raytracing_studio_tpu.utils import flacio as jflac
from audio_raytracing_studio_tpu.utils import wavio as jwav
from audio_raytracing_studio_tpu_torch.utils import _native_flac, _native_pcm, kernels
from audio_raytracing_studio_tpu_torch.utils import flacio as tflac
from audio_raytracing_studio_tpu_torch.utils import wavio as twav


def signal(n, channels, seed, gain=0.3):
    """Seeded tones plus noise, one frequency per channel, float32."""
    r = np.random.default_rng(seed)
    t = np.arange(n)
    x = np.stack([np.sin(2 * np.pi * (0.01 + 0.003 * c) * t) for c in range(channels)], axis=1)
    return (gain * x + 0.05 * r.standard_normal((n, channels))).astype(np.float32)


def outcome(fn, *args):
    """("ok", result) or (exception class name, message)."""
    try:
        return "ok", fn(*args)
    except Exception as e:  # noqa: BLE001 — the class and message are compared
        return type(e).__name__, str(e)


def same_outcome(a, b):
    if a[0] != b[0]:
        return False
    if a[0] != "ok":
        return a[1] == b[1]
    if isinstance(a[1], dict):
        return a[1] == b[1]
    (x, rx), (y, ry) = a[1], b[1]
    return rx == ry and np.array_equal(x, y)


def flac_bytes(module, x, rate, bps, blocksize=4096):
    buf = io.BytesIO()
    module.write(buf, x, rate, bits_per_sample=bps, blocksize=blocksize)
    return buf.getvalue()


# ------------------------------------------------------------------ FLAC ---


@pytest.mark.parametrize("rate", [8000, 44100, 96000])
@pytest.mark.parametrize("channels", [1, 2, 6, 8])
@pytest.mark.parametrize("bps", [16, 24])
def test_flac_bytes_and_samples_equal_jax(rate, channels, bps):
    x = signal(int(0.04 * rate) + 123, channels, seed=rate + channels + bps)
    port, jax = flac_bytes(tflac, x, rate, bps), flac_bytes(jflac, x, rate, bps)
    assert port == jax
    (a, ra), (b, rb) = tflac.read(io.BytesIO(jax)), jflac.read(io.BytesIO(port))
    assert ra == rb == rate and a.shape == (x.shape[0], channels)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("bps, blocksize", [(8, 4096), (16, 1152), (24, 576)])
def test_flac_depths_and_blocksizes_equal_jax(bps, blocksize):
    x = signal(5000, 2, seed=bps)
    port = flac_bytes(tflac, x, 22050, bps, blocksize)
    assert port == flac_bytes(jflac, x, 22050, bps, blocksize)
    np.testing.assert_array_equal(np.asarray(tflac.read(io.BytesIO(port))[0]),
                                  np.asarray(jflac.read(io.BytesIO(port))[0]))


@pytest.mark.parametrize("subtype", ["PCM_16", "FLOAT"])
@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_write_audio_flac_equal_jax(tmp_path, subtype, dtype):
    """``write_audio`` to .flac: 16 bit for PCM_16, 24 bit otherwise, and an
    int16 buffer taken as PCM16 samples."""
    x = signal(3000, 2, seed=7)
    if dtype == "int16":
        x = twav.encode_pcm16(x)
    twav.write_audio(tmp_path / "t.flac", x, 48000, subtype=subtype)
    jwav.write_audio(tmp_path / "j.flac", x, 48000, subtype=subtype)
    assert (tmp_path / "t.flac").read_bytes() == (tmp_path / "j.flac").read_bytes()
    for fn in ("read", "probe", "info"):
        got = outcome(getattr(twav, fn), tmp_path / "t.flac")
        assert got[0] == "ok" and same_outcome(got, outcome(getattr(jwav, fn),
                                                            tmp_path / "t.flac"))


@pytest.mark.parametrize("cut", [4, 20, 41, 0.3, 0.5, 0.9, -1])
def test_truncated_flac_raises_as_jax(tmp_path, cut):
    """Cut inside the magic, STREAMINFO, the first frame header, mid-stream
    and one byte short: the same class and message from read, probe and
    info (a truncated stream is the JAX package's German ValueError)."""
    raw = flac_bytes(tflac, signal(6000, 2, seed=1), 16000, 16, blocksize=1024)
    end = cut if isinstance(cut, int) else int(cut * len(raw))
    path = tmp_path / "cut.flac"
    path.write_bytes(raw[:end])
    for fn in ("read", "probe", "info"):
        got, want = outcome(getattr(twav, fn), path), outcome(getattr(jwav, fn), path)
        assert same_outcome(got, want), (fn, got, want)
    assert outcome(twav.read, path)[0] == "ValueError"


@pytest.mark.parametrize("seed", range(6))
def test_corrupt_flac_raises_as_jax(tmp_path, seed):
    """A few flipped bits past the magic: the same outcome (a CRC error, a
    header error or, where the damage stays in range, the same samples)."""
    rng = np.random.default_rng(seed)
    raw = bytearray(flac_bytes(tflac, signal(4000, 2, seed=2), 16000, 16, blocksize=1024))
    for _ in range(1 + seed):
        raw[int(rng.integers(4, len(raw)))] ^= 1 << int(rng.integers(0, 8))
    path = tmp_path / "flip.flac"
    path.write_bytes(bytes(raw))
    got, want = outcome(twav.read, path), outcome(jwav.read, path)
    assert same_outcome(got, want), (got, want)
    got, want = outcome(tflac.read, io.BytesIO(bytes(raw))), \
        outcome(jflac.read, io.BytesIO(bytes(raw)))
    assert same_outcome(got, want), (got, want)


def test_flac_crc_known_answers():
    assert tflac.crc8(b"123456789") == 0xF4  # CRC-8 poly 0x07, init 0
    assert tflac.crc16(b"123456789") == 0xFEE8  # CRC-16/UMTS, poly 0x8005


def test_flac_frame_header_by_hand():
    """The first frame of a one-frame stream, parsed against the spec: the
    sync code, the header's CRC-8 and the frame's CRC-16."""
    raw = flac_bytes(tflac, signal(3000, 2, seed=3), 44100, 16)
    assert raw[:4] == b"fLaC"
    pos, last = 4, False
    while not last:  # metadata blocks: 1-bit last flag, 7-bit type, 24-bit length
        last = bool(raw[pos] & 0x80)
        pos += 4 + int.from_bytes(raw[pos + 1:pos + 4], "big")
    frame = raw[pos:]
    assert frame[0] == 0xFF and frame[1] == 0xF8  # sync, fixed blocksize
    bs_code, sr_code = frame[2] >> 4, frame[2] & 0xF
    assert frame[3] >> 4 < 11 and (frame[3] >> 1) & 0x7 == 4  # 16 bits per sample
    hlen = 4 + 1  # frame number 0 in one UTF-8 byte
    hlen += {6: 1, 7: 2}.get(bs_code, 0) + {12: 1, 13: 2, 14: 2}.get(sr_code, 0)
    assert frame[4] == 0 and tflac.crc8(frame[:hlen]) == frame[hlen]
    assert tflac.crc16(frame[:-2]) == int.from_bytes(frame[-2:], "big")


def test_flac_native_tier_equals_numpy_tier(monkeypatch):
    x = signal(5000, 2, seed=4)
    data = bytes(range(256)) * 3
    native = (flac_bytes(tflac, x, 16000, 16), tflac.crc8(data), tflac.crc16(data))
    assert _native_flac.available()
    monkeypatch.setattr(_native_flac, "available", lambda: False)
    plain = (flac_bytes(tflac, x, 16000, 16), tflac.crc8(data), tflac.crc16(data))
    assert plain == native
    np.testing.assert_array_equal(np.asarray(tflac.read(io.BytesIO(native[0]))[0]),
                                  np.asarray(jflac.read(io.BytesIO(native[0]))[0]))


# ----------------------------------------------------------------- PCM16 ---


def pcm_cases():
    r = np.random.default_rng(11)
    halves = (np.arange(-40, 40) + 0.5) / 32768.0  # round half to even
    edges = np.array([1.0, -1.0, 1.5, -1.5, 0.99998, -0.99998, 1e-9, -0.0, 0.0])
    return np.concatenate([halves, edges, 3.0 * r.standard_normal(5000)]).astype(np.float32)


def test_pcm16_native_tier_equals_numpy_tier_and_jax(monkeypatch):
    x = pcm_cases().reshape(-1, 1)
    native = twav.encode_pcm16(x)
    back = twav.decode_pcm16(native)
    assert _native_pcm.available()
    np.testing.assert_array_equal(native, jwav.encode_pcm16(x))
    monkeypatch.setattr(_native_pcm, "available", lambda: False)
    np.testing.assert_array_equal(twav.encode_pcm16(x), native)
    np.testing.assert_array_equal(twav.decode_pcm16(native), back)
    np.testing.assert_array_equal(back, jwav.decode_pcm16(native))


# ------------------------------------------------------------ build_host ---


def test_build_host_names_by_source_flags_and_link(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    path = kernels.build_host("pcm_codec")
    source = (kernels.HOST_SRC_DIR / "pcm_codec.cc").read_bytes()
    digest = hashlib.sha256(source + " ".join(kernels.CXX_FLAGS).encode()).hexdigest()[:16]
    assert path == tmp_path / f"libpcm_codec_{digest}.so" and path.stat().st_size > 0
    assert kernels.build_host("pcm_codec") == path  # built once, then found
    linked = kernels.build_host("pcm_codec", ("-lm",))
    assert linked != path and linked.exists()
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted([path.name, linked.name])


def test_build_host_builds_once_under_threads(monkeypatch, tmp_path):
    runs = []

    def fake_gxx(cmd, **kw):
        runs.append(cmd)
        time.sleep(0.2)  # long enough for every thread to arrive
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"\x7fELF")

        class Done:
            returncode, stdout, stderr = 0, "", ""

        return Done()

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(kernels.subprocess, "run", fake_gxx)
    paths = []
    threads = [threading.Thread(target=lambda: paths.append(kernels.build_host("flac_core")))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert len(runs) == 1 and runs[0][0] == "g++" and len(set(paths)) == 1 and len(paths) == 8
    assert [p.name for p in (tmp_path / "_build").iterdir()] == [paths[0].name]


def test_build_host_builds_different_libraries_in_parallel(monkeypatch, tmp_path):
    """The lock is per source: two libraries' compilers run at once."""
    inside, both = [], threading.Event()

    def fake_gxx(cmd, **kw):
        inside.append(cmd)
        if len(inside) == 2:
            both.set()
        both.wait(timeout=10)
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"\x7fELF")

        class Done:
            returncode, stdout, stderr = 0, "", ""

        return Done()

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(kernels.subprocess, "run", fake_gxx)
    threads = [threading.Thread(target=kernels.build_host, args=(name,))
               for name in ("flac_core", "vorbis_core")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert both.is_set() and len(inside) == 2


def test_build_host_surfaces_compiler_errors(monkeypatch, tmp_path):
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "pcm_codec.cc").write_text("this is not C++;\n")
    monkeypatch.setattr(kernels, "HOST_SRC_DIR", tmp_path / "src")
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build pcm_codec.cc"):
        kernels.build_host("pcm_codec")
    # no half-written library: only the failure's marker
    assert [p.suffix for p in (tmp_path / "build").iterdir()] == [".failed"]


def test_build_host_remembers_a_failed_build(monkeypatch, tmp_path):
    """A failed build leaves ``lib<name>_<sha>.failed``: a later call (a
    later process) raises the compiler's message again without running g++;
    an edited source has another hash and builds."""
    (tmp_path / "src").mkdir()
    source = tmp_path / "src" / "pcm_codec.cc"
    source.write_text("this is not C++;\n")
    monkeypatch.setattr(kernels, "HOST_SRC_DIR", tmp_path / "src")
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError) as first:
        kernels.build_host("pcm_codec", ("-lm",))
    marker, = (tmp_path / "build").iterdir()
    digest = hashlib.sha256(source.read_bytes() + " ".join([*kernels.CXX_FLAGS, "-lm"]).encode())
    assert marker.name == f"libpcm_codec_{digest.hexdigest()[:16]}.failed"
    runs = []
    real_run = kernels.subprocess.run
    monkeypatch.setattr(kernels.subprocess, "run",
                        lambda cmd, **kw: runs.append(cmd) or real_run(cmd, **kw))
    with pytest.raises(RuntimeError) as again:
        kernels.build_host("pcm_codec", ("-lm",))
    assert runs == [] and str(again.value).startswith(str(first.value))
    assert "an earlier build failed" in str(again.value)
    source.write_text((kernels.PACKAGE_DIR / "utils" / "_native" / "pcm_codec.cc").read_text())
    assert kernels.build_host("pcm_codec", ("-lm",)).exists() and len(runs) == 1


def test_warm_native_reports_every_host_library():
    from audio_raytracing_studio_tpu_torch.utils import lavcio

    warm = twav.warm_native()
    assert sorted(warm) == ["flac", "lavc", "pcm", "vorbis"]
    assert all(warm[k]["available"] for k in ("pcm", "flac", "vorbis"))  # g++ builds them here
    assert warm["lavc"]["available"] == lavcio.decode_available()
    assert all(w["s"] >= 0.0 for w in warm.values())


def test_loaders_build_in_the_port_and_never_load_the_jax_library():
    """Each native loader's library comes from ``build_host`` into the
    port's ``_build/`` — never a library beside the JAX package's sources."""
    from audio_raytracing_studio_tpu_torch.utils import _native_vorbis

    for mod, name in ((_native_pcm, "pcm_codec"), (_native_flac, "flac_core"),
                      (_native_vorbis, "vorbis_core")):
        assert mod.available()
        path = kernels.build_host(name)
        assert path.parent == kernels.BUILD_DIR and path.name.startswith(f"lib{name}_")
        assert mod.lib()._name == str(path)
