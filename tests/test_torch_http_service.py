"""The port's HTTP job API (``serving/service.py``) on the CPU, beside the
JAX package's on the same requests.

The same request goes to both services: the status codes and the JSON keys
must agree (the port's ``/v1/stats`` swaps the JAX runtime's two memory
fields for its own five), and a rendered job's WAV must agree within 1 LSB
of PCM16 plus float round-off (2e-5).  The port-only cases: the served WAV
equals ``wavio.write`` of the direct ``render_batch`` bit for bit, and
``UploadStore.allowed()`` is a read-only test (jobs ``touch()`` what they
read).  FLAC and Ogg results and FLAC / Ogg / MP3 uploads go through both
services: lossless results within 1 LSB of the JAX service's, Ogg within
40 dB SNR (the two renders differ by ~1e-6).

Every wait has a timeout.
"""

import dataclasses
import io
import json
import os
import socket
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from audio_raytracing_studio_tpu.serving import RenderService as JaxService
from audio_raytracing_studio_tpu.serving.service import RenderHTTPService as JaxHTTPService
from audio_raytracing_studio_tpu_torch import RenderParams
from audio_raytracing_studio_tpu_torch.parallel import sharding
from audio_raytracing_studio_tpu_torch.serving import RenderService
from audio_raytracing_studio_tpu_torch.serving import service as port_service
from audio_raytracing_studio_tpu_torch.serving.service import RenderHTTPService
from audio_raytracing_studio_tpu_torch.utils import wavio
from audio_raytracing_studio_tpu_torch.utils.presets import PresetStore
from audio_raytracing_studio_tpu_torch.utils.uploads import UploadStore

torch.set_num_threads(1)

RATE = 16000
RUNTIME_KEYS_JAX = {"executables", "device_buffer_mb"}
RUNTIME_KEYS_PORT = {"device_allocated_mb", "device_reserved_mb", "fft_plans", "fft_plans_max",
                     "pinned_mb"}
PARAMS = {"target_layout": "Stereo", "room_size": 50.0}


def make_clip(i, seconds=0.3):
    t = np.arange(int(seconds * RATE)) / RATE
    return (0.3 * np.sin(2 * np.pi * (150 + 40 * i) * t)).astype(np.float32)


def wav_bytes(data, rate=RATE):
    buf = io.BytesIO()
    wavio.write(buf, data, rate)
    return buf.getvalue()


def call(http, method, path, body=None, headers=None):
    """One request → (status, parsed JSON or raw bytes); error statuses are
    returned, not raised."""
    req = urllib.request.Request(f"http://127.0.0.1:{http.port}{path}", data=body,
                                 headers=headers or {}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            code, raw, kind = r.status, r.read(), r.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        code, raw, kind = e.code, e.read(), e.headers.get("Content-Type", "")
    return code, (json.loads(raw) if kind.startswith("application/json") else raw)


def upload(http, i=0, seconds=0.3, name=None):
    clip = make_clip(i, seconds)
    code, body = call(http, "POST", "/v1/upload", wav_bytes(clip),
                      {"X-Filename": name or f"clip{i}.wav"})
    assert code == 200
    return body["path"]


def post_job(http, payload):
    return call(http, "POST", "/v1/jobs", json.dumps(payload).encode())


def poll_done(http, job_id, timeout=300):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        code, status = call(http, "GET", f"/v1/jobs/{job_id}")
        assert code == 200
        if status["status"] != "queued":
            return status
        time.sleep(0.05)
    raise TimeoutError(job_id)


def port_http(start=True, **kw):
    svc = RenderService(max_batch=4, max_wait_ms=30, pcm16_output=True, device="cpu",
                        start=start)
    return RenderHTTPService(svc, host="127.0.0.1", port=0, **kw).start()


@pytest.fixture(scope="module")
def port():
    http = port_http()
    yield http
    http.stop()


@pytest.fixture(scope="module")
def jax():
    http = JaxHTTPService(JaxService(max_batch=4, max_wait_ms=30), host="127.0.0.1",
                          port=0).start()
    yield http
    http.stop()


@pytest.fixture(scope="module")
def staged_pair():
    """Both services with their workers not started: every job stays queued."""
    pair = (
        JaxHTTPService(JaxService(max_batch=4, start=False), host="127.0.0.1", port=0).start(),
        port_http(start=False),
    )
    yield pair
    for http in pair:
        http.stop()


# ---------------------------------------------------------------- lifecycle


def test_job_lifecycle_matches_the_jax_service(jax, port, record_property):
    answers = {}
    for name, http in (("jax", jax), ("port", port)):
        path = upload(http, 0)
        code, job = post_job(http, {"input": path, "params": PARAMS, "seed": 4, "metrics": True})
        status = poll_done(http, job["job_id"])
        rcode, wav = call(http, "GET", f"/v1/jobs/{job['job_id']}/result")
        scode, stats = call(http, "GET", "/v1/stats")
        answers[name] = dict(code=code, job=job, status=status, rcode=rcode, wav=wav,
                             scode=scode, stats=stats)
    j, p = answers["jax"], answers["port"]
    assert j["code"] == p["code"] == 202
    assert set(j["job"]) == set(p["job"]) == {"job_id", "status"}
    assert j["job"]["status"] == p["job"]["status"] == "queued"
    assert j["status"]["status"] == p["status"]["status"] == "done", (j["status"], p["status"])
    assert set(j["status"]) == set(p["status"])
    for k in ("rate", "samples", "channels", "metrics_string"):
        assert j["status"][k] == p["status"][k], k
    gap = max(abs(j["status"]["metrics"][k] - p["status"]["metrics"][k])
              for k in ("lufs", "true_peak_dbfs", "rms_dbfs"))
    assert gap <= 0.01
    assert j["rcode"] == p["rcode"] == 200 and p["wav"][:4] == b"RIFF"
    a, rate_a = wavio.read(io.BytesIO(j["wav"]))
    b, rate_b = wavio.read(io.BytesIO(p["wav"]))
    assert rate_a == rate_b == RATE and a.shape == b.shape == (p["status"]["samples"], 2)
    audio_gap = float(np.abs(a - b).max())
    assert audio_gap <= 1.0 / 32768 + 2e-5
    assert j["scode"] == p["scode"] == 200
    assert set(j["stats"]) - RUNTIME_KEYS_JAX == set(p["stats"]) - RUNTIME_KEYS_PORT
    assert RUNTIME_KEYS_PORT <= set(p["stats"]) and p["stats"]["jobs_done"] >= 1
    record_property("port_vs_jax_http_wav_gap", audio_gap)
    record_property("port_vs_jax_http_metric_gap", gap)


def direct_pcm16(path, params, seed, external_ir=None):
    """The direct render of an uploaded clip as the service dispatches it:
    padded to its bucket, PCM16 on the device, trimmed to the true span."""
    audio, rate = wavio.read(path)
    bucket = sharding.bucket_length(audio.shape[0], rate)
    padded = np.pad(audio, ((0, bucket - audio.shape[0]), (0, 0)))[None]
    out, _ = sharding.render_batch(padded, rate, params, seeds=[seed], with_metrics=True,
                                   clip_lengths=[audio.shape[0]], pcm16_output=True,
                                   external_ir=external_ir, device="cpu")
    return out[0, : audio.shape[0] + out.shape[1] - bucket], rate


@pytest.mark.parametrize("metrics", [True, False])
def test_result_equals_the_direct_render_bit_for_bit(port, metrics):
    path = upload(port, 1)
    p = RenderParams(**PARAMS, diffusion=0.7)
    code, job = post_job(port, {"input": path, "params": p.to_preset_dict(), "seed": 11,
                                "metrics": metrics})
    assert code == 202
    status = poll_done(port, job["job_id"])
    assert status["status"] == "done" and ("metrics" in status) == metrics
    _, wav = call(port, "GET", f"/v1/jobs/{job['job_id']}/result")
    # the meter changes nothing in the audio: one direct render serves both
    assert wav == wav_bytes(*direct_pcm16(path, p, 11))


def test_external_ir_job_equals_the_direct_render(port, rng):
    ir = (0.3 * rng.standard_normal((400, 2))).astype(np.float32)
    _, up = call(port, "POST", "/v1/upload", wav_bytes(ir), {"X-Filename": "ir.wav"})
    path = upload(port, 2)
    payload = {"input": path, "params": {"use_external_ir": True, "target_layout": "Stereo"},
               "external_ir": up["path"], "seed": 1}
    code, job = post_job(port, payload)
    assert code == 202 and poll_done(port, job["job_id"])["status"] == "done"
    _, wav = call(port, "GET", f"/v1/jobs/{job['job_id']}/result")
    p = RenderParams(use_external_ir=True, target_layout="Stereo")
    assert wav == wav_bytes(*direct_pcm16(path, p, 1, external_ir=wavio.read(up["path"])[0]))
    # the IR upload is required in this mode
    code, err = post_job(port, {"input": path, "params": {"use_external_ir": True}})
    assert code == 400 and "external_ir" in err["error"]


def test_float_service_writes_the_same_pcm16_file():
    """A service that copies float32 down clips and encodes on the host; the
    default one quantizes on the device.  The files are the same."""
    files = []
    for pcm16 in (True, False):
        svc = RenderService(max_batch=2, max_wait_ms=20, pcm16_output=pcm16, device="cpu")
        http = RenderHTTPService(svc, host="127.0.0.1", port=0).start()
        try:
            path = upload(http, 3)
            _, job = post_job(http, {"input": path, "params": PARAMS, "seed": 2})
            assert poll_done(http, job["job_id"])["status"] == "done"
            files.append(call(http, "GET", f"/v1/jobs/{job['job_id']}/result")[1])
        finally:
            http.stop()
    assert files[0] == files[1]


def test_default_service_quantizes_on_the_device_and_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RenderHTTPService(host="127.0.0.1", port=0)


def test_main_without_a_card_exits_1(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert port_service.main(["--port", "0"]) == 1
    assert "CUDA" in capsys.readouterr().err


def test_main_builds_the_host_codecs_before_serving(monkeypatch):
    """``main`` runs ``wavio.warm_native`` before it serves, so g++ never
    runs inside a request."""
    calls = []
    monkeypatch.setattr(port_service.wavio, "warm_native", lambda: calls.append("warm") or {})

    def serve(self):
        calls.append("serve")
        self.start()  # serving in a thread, so the interrupt's stop() can shut it down
        raise KeyboardInterrupt

    monkeypatch.setattr(port_service.RenderHTTPService, "serve_forever", serve)
    assert port_service.main(["--host", "127.0.0.1", "--port", "0", "--device", "cpu"]) == 0
    assert calls == ["warm", "serve"]


def test_preset_job(tmp_path):
    store = PresetStore(str(tmp_path))
    saved = RenderParams(diffusion=0.77, **PARAMS)
    _, fname = store.save("ServePreset", saved)
    store.save_last("")
    http = port_http(preset_dir=str(tmp_path))
    try:
        path = upload(http, 7)
        code, job = post_job(http, {"input": path, "preset": fname, "params": {"x_pos": 0.9},
                                    "seed": 2, "metrics": False})
        assert code == 202 and poll_done(http, job["job_id"])["status"] == "done"
        _, wav = call(http, "GET", f"/v1/jobs/{job['job_id']}/result")
        merged = dataclasses.replace(saved, x_pos=0.9)  # 'params' override the preset
        assert wav == wav_bytes(*direct_pcm16(path, merged, 2))
        assert fname in call(http, "GET", "/v1/presets")[1]["presets"]
        code, err = post_job(http, {"input": path, "preset": "nope_v4.json"})
        assert code == 400 and "preset" in err["error"]
        assert store.load_last() in (None, "")  # the service left the last-used pointer alone
    finally:
        http.stop()


# ---------------------------------------------------------------- error contracts


BAD_JOBS = [
    ("list", [[1, 2]], 400, "JSON object"),
    ("number", 5, 400, "JSON object"),
    ("string", "input", 400, "JSON object"),
    ("null", None, 400, "JSON object"),
    ("true", True, 400, "JSON object"),
    ("no-input", {"params": {}}, 400, "input"),
    ("not-uploaded", {"input": "/etc/passwd", "params": {}}, 403, "upload"),
    ("format", {"input": "{clip}", "format": "mp9"}, 400, "format"),
    ("seed", {"input": "{clip}", "seed": [3]}, 400, "seed"),
    ("params", {"input": "{clip}", "params": ["x"]}, 400, "params"),
    ("preset", {"input": "{clip}", "preset": "nope_v4.json"}, 400, "preset"),
    ("no-ir", {"input": "{clip}", "params": {"use_external_ir": True}}, 400, "external_ir"),
]


@pytest.mark.parametrize("name, payload, code, word", BAD_JOBS, ids=[b[0] for b in BAD_JOBS])
def test_bad_jobs_answer_as_the_jax_service_does(staged_pair, name, payload, code, word):
    for http in staged_pair:
        body = payload
        if isinstance(payload, dict) and payload.get("input") == "{clip}":
            body = dict(payload, input=upload(http, 3))
        got, err = post_job(http, body)
        assert got == code, (type(http).__module__, err)
        assert set(err) == {"error"} and word in err["error"]


GETS = [
    ("unknown-job", "GET", "/v1/jobs/" + "0" * 32, 404),
    ("unknown-result", "GET", "/v1/jobs/" + "0" * 32 + "/result", 404),
    ("unknown-path", "GET", "/v1/nothing", 404),
    ("bad-id", "GET", "/v1/jobs/xyz", 404),
    ("delete-unknown", "DELETE", "/v1/jobs/" + "f" * 32, 404),
    ("delete-path", "DELETE", "/v1/stats", 404),
    ("post-path", "POST", "/v1/nothing", 404),
    ("presets", "GET", "/v1/presets", 200),
    ("stats", "GET", "/v1/stats", 200),
]


@pytest.mark.parametrize("name, method, path, code", GETS, ids=[g[0] for g in GETS])
def test_paths_answer_as_the_jax_service_does(staged_pair, name, method, path, code):
    answers = [call(http, method, path, b"{}" if method == "POST" else None)
               for http in staged_pair]
    assert [a[0] for a in answers] == [code, code]
    if code == 404:
        assert answers[0][1] == answers[1][1]  # the same error body
    elif name == "presets":
        assert set(answers[0][1]) == set(answers[1][1]) == {"presets"}


def raw_request(http, head: bytes) -> bytes:
    with socket.create_connection(("127.0.0.1", http.port), timeout=30) as s:
        s.sendall(head)
        return s.recv(64).split(b"\r\n", 1)[0]


@pytest.mark.parametrize("length, code", [(-7, b"400"), (513 * 1024 * 1024, b"413")],
                         ids=["negative", "too-large"])
def test_content_length_contracts(staged_pair, length, code):
    """A negative Content-Length must never reach ``rfile.read(-1)`` (it would
    pin the handler thread), an oversize one is refused unread; both close
    the connection and leave the server alive."""
    for http in staged_pair:
        line = raw_request(http, b"POST /v1/jobs HTTP/1.1\r\nHost: x\r\nContent-Length: "
                           + str(length).encode() + b"\r\nConnection: close\r\n\r\n")
        assert code in line, (type(http).__module__, line)
        assert "jobs_known" in call(http, "GET", "/v1/stats")[1]


def served_audio(http, job_id, tmp_path, ext, tag):
    """A finished job's result, decoded through a file of its format."""
    code, blob = call(http, "GET", f"/v1/jobs/{job_id}/result")
    assert code == 200 and isinstance(blob, bytes)
    path = tmp_path / f"{tag}.{ext}"
    path.write_bytes(blob)
    return wavio.read(path)


def snr_db(want, got):
    err = np.sum((got.astype(np.float64) - want) ** 2)
    return float(10 * np.log10(np.sum(want.astype(np.float64) ** 2) / max(err, 1e-30)))


@pytest.mark.parametrize("fmt", ["flac", "ogg", "FLAC"])
def test_flac_and_ogg_results_are_refused(jax, port, tmp_path, record_property, fmt):
    """A job asking for a FLAC or Ogg result (the name in any case) is
    accepted by both services and served in that container: FLAC within 1
    LSB of the JAX service's, Ogg of the same shape within 40 dB SNR; an
    unknown format answers both with the same 400."""
    got = {}
    for name, http in (("jax", jax), ("port", port)):
        code, job = post_job(http, {"input": upload(http, 2), "params": PARAMS, "seed": 8,
                                    "format": fmt})
        assert code == 202, job
        assert poll_done(http, job["job_id"])["status"] == "done"
        got[name] = served_audio(http, job["job_id"], tmp_path, fmt.lower(), name)
    (a, rate), (b, want_rate) = got["port"], got["jax"]
    assert rate == want_rate == RATE and a.shape == b.shape
    if fmt.lower() == "flac":
        lsb = int(np.abs(np.rint(a * 32768.0) - np.rint(b * 32768.0)).max())
        record_property("pcm16_lsb", lsb)
        assert lsb <= 1
    else:
        record_property("snr_db", snr_db(b, a))
        assert snr_db(b, a) >= 40.0
    errors = [post_job(http, {"input": upload(http, 2), "format": fmt + "x"})
              for http in (jax, port)]
    assert errors[0] == errors[1] and errors[0][0] == 400


@pytest.mark.parametrize("ext", ["flac", "ogg", "mp3"])
def test_compressed_uploads_match_the_jax_service(jax, port, tmp_path, record_property, ext):
    """A FLAC, Ogg or MP3 upload decoded by each service on its request
    thread and rendered: the WAV results within 1 LSB of each other."""
    from audio_raytracing_studio_tpu_torch.utils import mp3io

    if ext == "mp3" and not (mp3io.encode_available() and mp3io.decode_available()):
        pytest.skip("libmp3lame / libmpg123 are not loadable here")
    src = tmp_path / f"up.{ext}"
    x = make_clip(6, 0.4)
    wavio.write_audio(src, np.stack([x, 0.6 * x[::-1]], axis=1), RATE)
    got = {}
    for name, http in (("jax", jax), ("port", port)):
        code, body = call(http, "POST", "/v1/upload", src.read_bytes(),
                          {"X-Filename": src.name})
        assert code == 200
        code, job = post_job(http, {"input": body["path"], "params": PARAMS, "seed": 3})
        assert code == 202, job
        assert poll_done(http, job["job_id"])["status"] == "done"
        got[name] = served_audio(http, job["job_id"], tmp_path, "wav", name)
    (a, rate), (b, want_rate) = got["port"], got["jax"]
    assert rate == want_rate and a.shape == b.shape
    lsb = int(np.abs(np.rint(a * 32768.0) - np.rint(b * 32768.0)).max())
    record_property("pcm16_lsb", lsb)
    assert lsb <= 1


def test_queued_result_is_409_and_cancel_is_410(staged_pair):
    for http in staged_pair:
        _, job = post_job(http, {"input": upload(http, 5), "params": PARAMS})
        jid = job["job_id"]
        code, err = call(http, "GET", f"/v1/jobs/{jid}/result")
        assert code == 409 and "queued" in err["error"]
        code, res = call(http, "DELETE", f"/v1/jobs/{jid}")
        assert code == 200 and res == {"job_id": jid, "status": "cancelled", "cancelled": True}
        assert call(http, "GET", f"/v1/jobs/{jid}")[1] == {"job_id": jid, "status": "cancelled"}
        code, err = call(http, "GET", f"/v1/jobs/{jid}/result")
        assert code == 410 and "cancelled" in err["error"]


def test_cancelled_job_is_never_dispatched():
    http = port_http(start=False)
    try:
        _, job = post_job(http, {"input": upload(http, 5), "params": PARAMS})
        assert call(http, "DELETE", f"/v1/jobs/{job['job_id']}")[1]["cancelled"] is True
        http.service.start()
        http.service.stop()
        st = http.service.stats()
        assert st["batches"] == 0 and st["inflight_input_bytes"] == 0
    finally:
        http.stop()


def test_overloaded_and_stopped_service_answer_503():
    for make in (
        lambda: JaxHTTPService(JaxService(max_batch=2, max_queued=1, start=False),
                               host="127.0.0.1", port=0),
        lambda: RenderHTTPService(RenderService(max_batch=2, max_queued=1, device="cpu",
                                                start=False), host="127.0.0.1", port=0),
    ):
        http = make().start()
        try:
            path = upload(http, 0)
            assert post_job(http, {"input": path, "params": PARAMS})[0] == 202
            code, err = post_job(http, {"input": path, "params": PARAMS})
            assert code == 503 and "overloaded" in err["error"]
            http.service.stop()
            code, err = post_job(http, {"input": path, "params": PARAMS})
            assert code == 503 and "stopped" in err["error"]
        finally:
            http.stop()


def test_long_upload_is_served_by_the_streaming_renderer(record_property):
    """Past ``streaming_threshold_s`` the job renders through the streaming
    renderer in both services: the same answers, WAVs within 1 LSB, and the
    port's WAV equal to ``wavio.write`` of its direct ``render_streaming``."""
    from audio_raytracing_studio_tpu_torch.parallel.streaming import render_streaming

    params = dict(PARAMS, air_absorption=0.0)  # no exact-air transform to compile on the JAX side
    answers = {}
    for name, make in (
        ("jax", lambda: JaxHTTPService(
            JaxService(max_batch=2, max_wait_ms=20, streaming_threshold_s=0.2,
                       chunk_seconds=0.25),
            host="127.0.0.1", port=0)),
        ("port", lambda: RenderHTTPService(
            RenderService(max_batch=2, max_wait_ms=20, streaming_threshold_s=0.2,
                          chunk_seconds=0.25, pcm16_output=True, device="cpu"),
            host="127.0.0.1", port=0)),
    ):
        http = make().start()
        try:
            path = upload(http, 3, seconds=0.3)
            code, job = post_job(http, {"input": path, "params": params, "seed": 2})
            status = poll_done(http, job["job_id"])
            _, wav = call(http, "GET", f"/v1/jobs/{job['job_id']}/result")
            stats = call(http, "GET", "/v1/stats")[1]
            answers[name] = dict(code=code, status=status, wav=wav, stats=stats,
                                 upload=wavio.read(path))
        finally:
            http.stop()
    j, p = answers["jax"], answers["port"]
    assert j["code"] == p["code"] == 202
    assert j["status"]["status"] == p["status"]["status"] == "done", (j["status"], p["status"])
    assert j["stats"]["batch_sizes"] == p["stats"]["batch_sizes"] == [1]
    for k in ("rate", "samples", "channels"):
        assert j["status"][k] == p["status"][k], k
    a, _ = wavio.read(io.BytesIO(j["wav"]))
    b, _ = wavio.read(io.BytesIO(p["wav"]))
    gap = float(np.abs(a - b).max())
    record_property("port_vs_jax_streamed_wav_gap", gap)
    assert a.shape == b.shape and gap <= 1.0 / 32768 + 2e-5
    audio, rate = p["upload"]
    direct = render_streaming(audio, rate, RenderParams(**params), seed=2, chunk_seconds=0.25,
                              pcm16_output=True, fast_filters=False, device="cpu")
    assert p["wav"] == wav_bytes(direct, rate)


# ---------------------------------------------------------------- retention


def test_completed_job_retention_is_bounded():
    http = port_http(max_jobs=2)
    try:
        payload = {"input": upload(http, 6), "params": PARAMS}
        _, first = post_job(http, payload)
        poll_done(http, first["job_id"])
        call(http, "GET", f"/v1/jobs/{first['job_id']}/result")  # materialize its file
        first_path = http._entry(first["job_id"]).result_path
        assert first_path and os.path.exists(first_path)
        for _ in range(2):
            poll_done(http, post_job(http, payload)[1]["job_id"])
        assert call(http, "GET", f"/v1/jobs/{first['job_id']}")[0] == 404
        assert not os.path.exists(first_path)
    finally:
        http.stop()
    with pytest.raises(ValueError, match="max_jobs"):
        RenderHTTPService(RenderService(device="cpu", start=False), port=0, max_jobs=0)


def test_upload_retention_is_bounded():
    http = port_http(start=False, max_uploads=2)
    try:
        paths = [upload(http, i) for i in range(3)]
        assert not os.path.exists(paths[0])
        assert os.path.exists(paths[1]) and os.path.exists(paths[2])
        code, err = post_job(http, {"input": paths[0], "params": {}})
        assert code == 403 and "upload" in err["error"]
    finally:
        http.stop()
    assert not os.path.exists(paths[1])  # stop() removed the directories


def test_upload_eviction_is_lru_by_job_references():
    """An upload that jobs keep reading (one IR, many jobs) outlives a stream
    of newer one-shot uploads: each job touches what it reads."""
    http = port_http(start=False, max_uploads=2)
    http.service.max_queued = 64
    try:
        shared = upload(http, 0)
        for i in range(1, 5):
            assert post_job(http, {"input": shared, "params": PARAMS})[0] == 202
            upload(http, i)
        assert os.path.exists(shared)
        assert post_job(http, {"input": shared, "params": PARAMS})[0] == 202
    finally:
        http.stop()


def test_allowed_leaves_the_lru_order_alone():
    """The gate check is read-only: probing it cannot steer eviction.  (The
    JAX package's ``allowed()`` moves the file to the fresh end.)"""
    store = UploadStore(prefix="ars_torch_test_", max_files=2)
    try:
        a = store.save("a.wav", b"a")
        b = store.save("b.wav", b"b")
        for _ in range(3):
            assert store.allowed(os.path.realpath(a))
        store.save("c.wav", b"c")  # evicts a: the probes did not refresh it
        assert not store.allowed(os.path.realpath(a)) and not os.path.exists(a)
        assert store.touch(os.path.realpath(b))  # a job reads b
        d = store.save("d.wav", b"d")  # evicts c, not b
        assert store.allowed(os.path.realpath(b)) and store.allowed(os.path.realpath(d))
        assert not store.touch("/etc/passwd") and not store.allowed("/etc/passwd")
    finally:
        store.cleanup()
    assert not store.allowed(os.path.realpath(b))


def test_upload_names_are_sanitized_and_never_collide():
    store = UploadStore(prefix="ars_torch_test_")
    try:
        first = store.save("../../etc/pass wd;.wav", b"1")
        second = store.save("../../etc/pass wd;.wav", b"2")
        assert os.path.dirname(first) == store.dir == os.path.dirname(second)
        assert os.path.basename(first) == "pass_wd_.wav" and second != first
        assert open(first, "rb").read() == b"1" and open(second, "rb").read() == b"2"
        assert os.path.basename(store.save("", b"3")) == "upload.bin"
    finally:
        store.cleanup()
    with pytest.raises(ValueError, match="max_files"):
        UploadStore(prefix="x", max_files=0)
