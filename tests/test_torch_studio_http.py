"""The port's studio HTTP server (app/server.py) beside the JAX package's:
one live server each on 127.0.0.1, the same requests to both.

Status codes and error bodies are **equal**; state snapshots are equal apart
from temp-file names and the two Markdown texts that name the backend; the
downloaded result WAVs agree within 1 PCM16 LSB and the port's equals what
``process_audio_main_v41`` wrote.  The refusals are the ones
tests/test_http_server.py holds the JAX server to: ``/file`` outside the
allowlist, planted and smuggled paths, unknown ids and listeners, wrong
payload types, a negative Content-Length, a NUL byte in a path.  The port's
upload store differs in one documented way: its gate is read-only and an
event that reads an upload marks it used.
"""

import io
import json
import os
import socket
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from audio_raytracing_studio_tpu.app import studio as jstudio
from audio_raytracing_studio_tpu.app.server import StudioHTTPServer as JServer
from audio_raytracing_studio_tpu.utils.presets import PresetStore as JStore
from audio_raytracing_studio_tpu_torch.app import marker as tmarker
from audio_raytracing_studio_tpu_torch.app import studio as tstudio
from audio_raytracing_studio_tpu_torch.app.server import StudioHTTPServer as TServer
from audio_raytracing_studio_tpu_torch.app.server import render_page
from audio_raytracing_studio_tpu_torch.utils import runtime, wavio
from audio_raytracing_studio_tpu_torch.utils.presets import PresetStore as TStore

torch.set_num_threads(1)

RATE = 16000


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One live server per package for the module, cwd-isolated, on the CPU."""
    import tempfile

    root = tmp_path_factory.mktemp("studio_http")
    old_cwd = os.getcwd()
    os.chdir(root)
    old_tempdir, tempfile.tempdir = tempfile.tempdir, str(root)  # the handlers' temp files
    previous = runtime.set_default_device("cpu")
    servers = []
    try:
        tmarker.ensure_map_asset()
        (root / "t").mkdir()
        (root / "j").mkdir()
        servers.append(TServer(tstudio.build_demo(TStore(str(root / "t"))),
                               host="127.0.0.1", port=0).start())
        servers.append(JServer(jstudio.build_demo(JStore(str(root / "j"))),
                               host="127.0.0.1", port=0).start())
        yield servers
    finally:
        for s in servers:
            s.stop()
        runtime.set_default_device(previous)
        tempfile.tempdir = old_tempdir
        os.chdir(old_cwd)


def call(server, path, data=None, headers=None, method=None):
    """(status, content type, body) — HTTP errors are answers, not exceptions."""
    req = urllib.request.Request(f"http://127.0.0.1:{server.port}{path}", data=data,
                                 headers=headers or {}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read()


def post(server, path, payload):
    status, _, body = call(server, path, json.dumps(payload).encode(), method="POST")
    return status, json.loads(body)


def state(server):
    return json.loads(call(server, "/state")[2])["components"]


def by_label(components, label, nth=0):
    matches = [c for c in components if c["label"] == label]
    assert matches, f"no component labeled {label!r}"
    return matches[nth]


def both(served, path, payload):
    """The same POST to both servers: equal status, and equal error text."""
    (st, bt), (sj, bj) = (post(s, path, payload) for s in served)
    assert st == sj, (path, payload, bt if st != 200 else "", bj if sj != 200 else "")
    if st != 200:
        assert bt == bj
    return st, bt, bj


def comparable(components):
    """A state snapshot without what may differ: temp names, backend texts."""
    out = []
    for c in components:
        c = dict(c)
        v = c["value"]
        if isinstance(v, str) and os.path.isabs(v):
            c["value"] = "<file" + os.path.splitext(v)[1] + ">"
            c.pop("url", None)
        elif isinstance(v, str) and v.startswith("LUFS: "):
            c["value"] = "<metrics>"
        elif c["type"] == "Markdown" and isinstance(v, str) and (
                "TPU" in v or "CUDA" in v):
            c["value"] = "<backend text>"
        out.append(c)
    return out


@pytest.fixture
def clip(tmp_path):
    t = np.arange(int(0.5 * RATE)) / RATE
    x = (0.5 * np.sin(2 * np.pi * 330.0 * t)).astype(np.float32)
    path = tmp_path / "http_in.wav"
    wavio.write(path, x, RATE)
    return str(path)


def upload(server, path, name="clip.wav"):
    with open(path, "rb") as fh:
        status, _, body = call(server, "/upload", fh.read(), {"X-Filename": name}, "POST")
    assert status == 200
    return json.loads(body)["path"]


def test_page_serves_tabs_and_controls(served):
    status, ctype, body = call(served[0], "/")
    assert status == 200 and ctype.startswith("text/html")
    page = body.decode("utf-8")
    for fragment in ("Audio-Verarbeitung &amp; Positionierung", "Visualizer", "Preset-Editor",
                     "Hilfe", "Verarbeiten &amp; Anhören!", "mapClick"):
        assert fragment in page, fragment
    assert render_page(served[0].blocks) == page
    ids_t = [c["id"] for c in state(served[0])]
    assert all(f'data-id="{i}"' in page for i in ids_t)


def test_state_snapshots_equal(served):
    t, j = state(served[0]), state(served[1])
    assert comparable(t) == comparable(j)
    assert "click" in by_label(t, "➡️ Verarbeiten & Anhören!")["events"]
    assert by_label(t, "📊 Ergebnis-Metriken (Gesamt)")["value"] == "Bereit. Bitte Audio laden."
    marker_png = by_label(t, "🎯 Position (X/Y)")
    assert marker_png["url"].startswith("/file?path=")
    status, ctype, body = call(served[0], marker_png["url"])
    assert status == 200 and ctype == "image/png" and body[:4] == b"\x89PNG"


@pytest.mark.parametrize("path", ["/nope", "/state/x", "/files"])
def test_unknown_routes_equal(served, path):
    (st, _, bt), (sj, _, bj) = (call(s, path) for s in served)
    assert st == sj == 404 and bt == bj
    assert both(served, path, {})[0] == 404


def test_upload_process_download(served, clip, record_property, monkeypatch):
    """The Tab-1 flow over the wire on both servers: upload → process → result."""
    monkeypatch.setattr(os, "urandom", lambda n: bytes([9, 0, 0, 0])[:n])  # the unseeded draw
    outs = []
    for server in served:
        uploaded = upload(server, clip)
        assert os.path.isfile(uploaded)
        comps = state(server)
        status, data = post(server, "/event", {
            "id": by_label(comps, "➡️ Verarbeiten & Anhören!")["id"], "event": "click",
            "set": {str(by_label(comps, "🔊 Audio hochladen")["id"]): uploaded,
                    str(by_label(comps, "🎯 Ziel-Layout")["id"]): "Stereo"}})
        assert status == 200
        result = by_label(data["components"], "🎧 Ergebnis anhören")
        assert "LUFS" in by_label(data["components"], "📊 Ergebnis-Metriken (Gesamt)")["value"]
        status, ctype, body = call(server, result["url"])
        assert status == 200 and ctype == "audio/wav"
        assert body == open(result["value"], "rb").read()
        outs.append(wavio.read(io.BytesIO(body)))
        os.remove(result["value"])
    (a, ra), (b, rb) = outs
    assert ra == rb == RATE and a.shape == b.shape and a.shape[0] > int(0.5 * RATE)
    lsb = int(np.abs(np.rint(a * 32768.0) - np.rint(b * 32768.0)).max())
    record_property("pcm16_lsb", lsb)
    assert lsb <= 1
    assert comparable(state(served[0])) == comparable(state(served[1]))


def test_an_event_marks_the_uploads_it_reads_as_used(served, clip):
    server = served[0]
    first = upload(server, clip, "first.wav")
    second = upload(server, clip, "second.wav")
    order = lambda: list(server._uploads._paths)  # noqa: E731 — least recently used first
    assert order()[-2:] == [os.path.realpath(first), os.path.realpath(second)]
    assert server.file_allowed(first)          # the gate itself reorders nothing
    assert order()[-1] == os.path.realpath(second)
    comps = state(server)
    vis_in = by_label(comps, "🔍 Original (Visualizer)")
    load_btn = by_label(comps, "Lade letztes Ergebnis (Bearb.)")
    status, _ = post(server, "/set", {"id": vis_in["id"], "value": first})
    assert status == 200 and order()[-1] == os.path.realpath(second)
    # this button's handler reads the download slot; point it at the upload
    dl = by_label(comps, "💾 Download Ergebnis")
    status, _ = post(server, "/event", {"id": load_btn["id"], "event": "click",
                                        "set": {str(dl["id"]): first}})
    assert status == 200 and order()[-1] == os.path.realpath(first)
    vis_out = by_label(comps, "🔍 Bearbeitet (Visualizer)")  # the button's output
    for comp in (vis_in, dl, vis_out):  # leave both servers in one state again
        assert both(served, "/set", {"id": comp["id"], "value": None})[0] == 200


def test_map_click_updates_sliders(served):
    comps = state(served[0])
    image = by_label(comps, "Karte (Klicken für X/Y)")
    w, h = tmarker.MAP_SIZE
    status, bt, bj = both(served, "/event", {"id": image["id"], "event": "select",
                                             "index": [int(0.75 * w), int(0.25 * h)]})
    assert status == 200
    assert by_label(bt["components"], "↔️ X (L/R)")["value"] == pytest.approx(0.75)
    assert by_label(bt["components"], "↕️ Y (F/B)")["value"] == pytest.approx(0.25)
    assert comparable(bt["components"]) == comparable(bj["components"])


def test_preset_roundtrip_over_http(served):
    comps = state(served[0])
    ids = {k: by_label(comps, k)["id"] for k in (
        "📝 Preset-Name", "💾 Speichern", "🏛️ Hall-Typ", "📏 Raumgröße (m³)", "📥 Laden",
        "📂 Presets (v4)", "🗑️ Löschen")}
    status, bt, bj = both(served, "/event", {"id": ids["💾 Speichern"], "event": "click", "set": {
        str(ids["📝 Preset-Name"]): "HTTP Preset", str(ids["🏛️ Hall-Typ"]): "Cathedral",
        str(ids["📏 Raumgröße (m³)"]): 600}})
    assert status == 200 and comparable(bt["components"]) == comparable(bj["components"])
    assert by_label(bt["components"], "📂 Presets (v4)")["value"] == "HTTP_Preset_v4.json"
    status, bt, bj = both(served, "/event", {"id": ids["📥 Laden"], "event": "click", "set": {
        str(ids["🏛️ Hall-Typ"]): "Plate", str(ids["📏 Raumgröße (m³)"]): 10}})
    assert status == 200 and comparable(bt["components"]) == comparable(bj["components"])
    assert by_label(bt["components"], "🏛️ Hall-Typ")["value"] == "Cathedral"
    assert by_label(bt["components"], "Status")["value"] == "Preset 'HTTP_Preset_v4.json' geladen."
    # a selection outside the choices is a 400 on both, and deletes nothing
    status, _, _ = both(served, "/event", {"id": ids["🗑️ Löschen"], "event": "click", "set": {
        str(ids["📂 Presets (v4)"]): "../../etc/passwd"}})
    assert status == 400
    status, bt, bj = both(served, "/event", {"id": ids["🗑️ Löschen"], "event": "click"})
    assert status == 200 and "gelöscht" in by_label(bt["components"], "Status")["value"]
    assert comparable(bt["components"]) == comparable(bj["components"])


@pytest.mark.parametrize("path", ["/etc/passwd", os.path.abspath(__file__), "relative.wav", ""])
def test_file_endpoint_is_allowlisted(served, path):
    answers = [call(s, "/file?path=" + urllib.parse.quote(path)) for s in served]
    assert answers[0][0] == answers[1][0] and answers[0][0] in (403, 404)
    assert answers[0][2] == answers[1][2]


def test_file_path_with_nul_byte_is_clean_404(served):
    for s in served:
        assert call(s, "/file?path=%00x")[0] == 404
        assert state(s)


def test_set_cannot_plant_or_smuggle_a_servable_path(served):
    comps = state(served[0])
    name = by_label(comps, "📝 Preset-Name")
    refresh = by_label(comps, "🔄 Liste neu laden")
    secret = os.path.abspath(__file__)
    for path, payload in (
        ("/set", {"id": name["id"], "value": secret}),
        ("/set", {"id": name["id"], "value": [secret]}),
        ("/set", {"id": name["id"], "value": {"k": [secret]}}),
        ("/event", {"id": refresh["id"], "event": "click", "set": {str(name["id"]): secret}}),
    ):
        assert both(served, path, payload)[0] == 403, payload
    for s in served:
        assert call(s, "/file?path=" + urllib.parse.quote(secret))[0] in (403, 404)
    status, bt, _ = both(served, "/set", {"id": name["id"], "value": "harmless_name"})
    assert status == 200
    assert by_label(bt["components"], "📝 Preset-Name")["value"] == "harmless_name"
    both(served, "/set", {"id": name["id"], "value": ""})


def test_rejected_event_applies_no_sets(served):
    comps = state(served[0])
    name = by_label(comps, "📝 Preset-Name")
    metrics = by_label(comps, "📊 Ergebnis-Metriken (Gesamt)")  # no click listener
    status, _, _ = both(served, "/event", {"id": metrics["id"], "event": "click",
                                           "set": {str(name["id"]): "must not stick"}})
    assert status == 400
    for s in served:
        assert by_label(state(s), "📝 Preset-Name")["value"] != "must not stick"


@pytest.mark.parametrize("path, payload", [
    ("/event", {"id": 10**6, "event": "click"}),
    ("/event", {"id": -1, "event": "click"}),
    ("/set", {"id": -2, "value": 1}),
    ("/set", {"id": 10**6, "value": 1}),
    ("/event", {"id": 0, "event": "no-such-event"}),
    ("/event", {"event": "click"}),
    ("/set", {"value": 3}),
    ("/event", {"id": [1], "event": "click"}),
    ("/event", {"id": "x", "event": "click"}),
    ("/event", {"id": 0, "event": {"a": 1}}),
    ("/event", {"id": 0, "event": "click", "index": "xy"}),
    ("/event", {"id": 0, "event": "click", "set": [1, 2]}),
    ("/set", [1, 2, 3]),
    ("/event", 5),
    ("/set", "text"),
], ids=["id-unknown", "id-negative", "set-id-negative", "set-id-unknown", "event-unknown",
        "event-no-id", "set-no-id", "id-list", "id-text", "event-dict", "index-text", "set-list",
        "body-list", "body-number", "body-text"])
def test_unknown_ids_and_wrong_types_are_400_on_both(served, path, payload):
    assert both(served, path, payload)[0] == 400


def test_invalid_json_and_negative_content_length(served):
    for s in served:
        status, _, _ = call(s, "/set", b"{not json", method="POST")
        assert status == 400
        with socket.create_connection(("127.0.0.1", s.port), timeout=30) as sock:
            sock.sendall(b"POST /set HTTP/1.1\r\nHost: x\r\nContent-Length: -7\r\n"
                         b"Connection: close\r\n\r\n")
            assert b"400" in sock.recv(64).split(b"\r\n", 1)[0]
        assert state(s)


@pytest.mark.parametrize("label, value, status", [
    ("💡 Externe Stereo IR verwenden?", "yes", 400),
    ("💡 Externe Stereo IR verwenden?", True, 200),
    ("💡 Externe Stereo IR verwenden?", False, 200),
    ("📏 Raumgröße (m³)", "big", 400),
    ("📏 Raumgröße (m³)", True, 400),
    ("📏 Raumgröße (m³)", 1e9, 200),      # clamped to the slider's range
    ("🏛️ Hall-Typ", "Nowhere", 400),
    ("🏛️ Hall-Typ", 7, 400),
    ("🏛️ Hall-Typ", "Plate", 200),
    ("📝 Preset-Name", 12, 400),
    ("📝 Preset-Name", None, 200),
])
def test_client_sets_are_type_vetted(served, label, value, status):
    comp = by_label(state(served[0]), label)
    got, bt, bj = both(served, "/set", {"id": comp["id"], "value": value, "fire_change": True})
    assert got == status
    if got == 200:
        assert comparable(bt["components"]) == comparable(bj["components"])
        if label.startswith("📏"):
            assert by_label(bt["components"], label)["value"] == comp["maximum"]


def test_handler_keyerror_is_500_not_400(served, monkeypatch):
    server = served[0]
    comps = state(server)
    hall = by_label(comps, "🏛️ Hall-Typ")
    for dep in server.blocks.deps_for(server.blocks.components[hall["id"]], "change"):
        monkeypatch.setattr(dep, "fn", lambda *_: {}["boom"])
    status, body = post(server, "/event", {"id": hall["id"], "event": "change"})
    assert status == 500 and "KeyError" in body["error"]


def test_upload_names_are_sanitized_and_do_not_collide(served, clip):
    server = served[0]
    a = upload(server, clip, urllib.parse.quote("träck ✓.wav"))
    b = upload(server, clip, "../../same.wav")
    c = upload(server, clip, "../../same.wav")
    assert len({a, b, c}) == 3
    for p in (a, b, c):
        assert os.path.dirname(p) == server._uploads.dir and p.endswith(".wav")
        assert call(server, "/file?path=" + urllib.parse.quote(p))[0] == 200


def test_visualizer_and_profiler_over_http(served, clip):
    server = served[0]
    uploaded = upload(server, clip)
    comps = state(server)
    sets = {str(by_label(comps, k)["id"]): uploaded for k in (
        "🔍 Original (Visualizer)", "🔍 Bearbeitet (Visualizer)", "Lade Original (Profiler)",
        "Lade Bearbeitet (Profiler)")}
    status, data = post(server, "/event", {
        "id": by_label(comps, "📊 Visualisieren")["id"], "event": "click", "set": sets})
    assert status == 200
    for label in ("🔵 Original Vis", "🟠 Bearbeitet Vis"):
        img = by_label(data["components"], label)
        status, ctype, body = call(server, img["url"])
        assert status == 200 and ctype == "image/png" and len(body) > 1000
        os.remove(img["value"])
    status, data = post(server, "/event", {
        "id": by_label(comps, "🚀 Analysieren!")["id"], "event": "click"})
    assert status == 200
    assert "Zusammenfassung" in by_label(data["components"], "📋 Analysebericht")["value"]
