"""Zero-dependency HTTP server for the studio UI — the port's own copy of
``audio_raytracing_studio_tpu/app/server.py`` over the port's
``utils.httpbase`` and ``utils.uploads``.

The reference's flagship surface is a served web app
(raytracer_studio.py:1397 — ``demo.launch(0.0.0.0:8861)``).
Where gradio is not installed, the package serves its own
headless Blocks runtime (app/_gradio_headless.py) over stdlib
``http.server``: GET / renders the 4-tab component tree as an HTML app,
JSON endpoints mirror the event runtime (set values, fire listeners,
upload clips, download results), and the clickable position map posts
pixel coordinates through the same ``SelectData`` path the gradio UI uses.

Endpoints
---------
GET  /            the studio page (HTML + inline JS client)
GET  /state       JSON snapshot of every component (id, type, value, …)
POST /set         {"id": N, "value": V, "fire_change": bool} → state
POST /event       {"id": N, "event": "click", "set": {id: value, …},
                   "index": [x, y]?} → apply sets, fire listeners → state
POST /upload      raw body + X-Filename header → {"path": …}
GET  /file?path=  stream a file (only uploads, current component values,
                  and the map assets — no arbitrary reads)

Threading: events run under one lock (the renders of one studio share one
device stream anyway); the server itself is threading so a long render
does not block state polls or file downloads.
"""

from __future__ import annotations

import html
import json
import logging
import math
import os
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler

from ..utils.httpbase import _CLIENT_GONE, QuietDisconnectHTTPServer
from typing import Any, Dict, List, Optional

from .. import config
from . import _gradio_headless as hl

log = logging.getLogger("ars_torch.server")

_CONTENT_TYPES = {
    ".wav": "audio/wav",
    ".flac": "audio/flac",
    ".aif": "audio/aiff",
    ".aiff": "audio/aiff",
    ".ogg": "audio/ogg",
    ".mp3": "audio/mpeg",
    ".m4a": "audio/mp4",
    ".mp4": "audio/mp4",
    ".aac": "audio/aac",
    ".png": "image/png",
    ".jpg": "image/jpeg",
    ".jpeg": "image/jpeg",
    ".json": "application/json",
    ".zip": "application/zip",
    ".txt": "text/plain; charset=utf-8",
}

_MAX_UPLOAD = 512 * 1024 * 1024  # 512 MB — covers hour-scale WAV uploads


class UnknownRouteTarget(Exception):
    """Bad component id / no such listener — a 400, distinct from KeyErrors
    raised inside application handlers (which must surface as 500s)."""


def _jsonable(value: Any) -> Any:
    """Serialize a component value for the wire (paths stay strings)."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    return repr(value)


def _vet_client_type(comp: "hl.Component", value: Any) -> Any:
    """Type-check (and for sliders, clamp) a CLIENT-set component value —
    the constraints real gradio's frontend enforces before a value can
    reach a handler.  Without this, POST /set can place arbitrary JSON in
    any component and the next event fires it into handler code that
    assumes UI-shaped inputs (``texts.get(unhashable_list)``, marker
    math on strings/Infinity, ...).  Server-side handler updates do NOT
    pass through here — handlers may hold richer values.

    Returns the (possibly clamped) value; raises ValueError on mismatch.
    """
    name = type(comp).__name__
    if isinstance(comp, hl.Checkbox):
        if not isinstance(value, bool):
            raise ValueError(f"{name} value must be a boolean")
        return value
    if isinstance(comp, (hl.Slider, hl.Number)):
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ValueError(f"{name} value must be a number")
        if not math.isfinite(value):
            raise ValueError(f"{name} value must be finite")
        if isinstance(comp, hl.Slider):
            # the real frontend can only produce in-range values
            return min(max(float(value), float(comp.minimum)),
                       float(comp.maximum))
        return value
    if isinstance(comp, hl.Dropdown):
        if value is None or value == "":
            # a <select> with no selection serializes as "" — the built-in
            # JS client echoes it for every null-valued dropdown on every
            # event POST, so "" must mean None or one deleted preset
            # bricks all subsequent UI events (review finding)
            return None
        if not isinstance(value, str):
            raise ValueError(f"{name} value must be a string")
        if value not in (comp.choices or []):
            # gradio's allow_custom_value=False default: a non-member
            # selection is a frontend impossibility — and with NO choices
            # nothing is selectable at all (an empty-choices waiver would
            # leave a pristine store's dropdown as an unvetted string slot)
            raise ValueError(f"{name} value must be one of its choices")
        return value
    # Textbox/Button/Label/Markdown/Image/File/Audio: strings (paths go
    # through the separate servability vetting) or null
    if value is None or isinstance(value, str):
        return value
    raise ValueError(f"{name} value must be a string")


def _iter_strings(value: Any):
    """Every string anywhere inside a (possibly nested) component value —
    the SAME traversal the file-serving allowlist uses, so the /set vetting
    can never see less than ``file_allowed`` will later trust."""
    if isinstance(value, str):
        yield value
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _iter_strings(v)
    elif isinstance(value, dict):
        for v in value.values():
            yield from _iter_strings(v)


def _listener_map(blocks: "hl.Blocks") -> Dict[int, set]:
    """component index → set of event names with listeners (one definition
    shared by the JSON state endpoint and the HTML page renderer)."""
    listeners: Dict[int, set] = {}
    for dep in blocks._all_deps:
        for i, c in enumerate(blocks.components):
            if dep.trigger is c:
                listeners.setdefault(i, set()).add(dep.event)
    return listeners


class StudioHTTPServer:
    """Serve a headless ``Blocks`` over HTTP.

    ``start()`` binds and serves on a daemon thread (tests);
    ``serve_forever()`` blocks (the CLI entry point).
    """

    def __init__(self, blocks: "hl.Blocks", host: str = "0.0.0.0", port: int = 0):
        from ..utils.uploads import UploadStore

        self.blocks = blocks
        self._lock = threading.Lock()
        self._uploads = UploadStore(prefix="ars_studio_uploads_")
        handler = self._make_handler()
        self.httpd = QuietDisconnectHTTPServer((host, port), handler)
        self.httpd.daemon_threads = True
        self.host, self.port = self.httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None
        # run the startup initializer exactly once, like gradio's page load
        with self._lock:
            self.blocks.startup()

    # --- lifecycle ---
    def start(self) -> "StudioHTTPServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def serve_forever(self):
        log.info("studio serving on http://%s:%d", self.host, self.port)
        self.httpd.serve_forever()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=10)
        self._uploads.cleanup()

    # --- state / events ---
    def _component(self, comp_id) -> "hl.Component":
        """Strict id → component: negative ids must 400, not silently index
        from the end of the component list."""
        try:
            i = int(comp_id)
        except (TypeError, ValueError):
            raise UnknownRouteTarget(f"no such component: {comp_id!r}") from None
        if not 0 <= i < len(self.blocks.components):
            raise UnknownRouteTarget(f"no such component: {comp_id}")
        return self.blocks.components[i]

    def component_state(self) -> List[Dict[str, Any]]:
        comps = self.blocks.components
        listeners = _listener_map(self.blocks)
        out = []
        for i, c in enumerate(comps):
            entry: Dict[str, Any] = {
                "id": i,
                "type": type(c).__name__,
                "label": c.label,
                "value": _jsonable(c.value),
                "interactive": bool(c.interactive),
                "visible": bool(c.visible),
                "tab": c.tab,
                "events": sorted(listeners.get(i, ())),
            }
            if c.choices is not None:
                entry["choices"] = [_jsonable(x) for x in c.choices]
            for attr in ("minimum", "maximum", "step"):
                if hasattr(c, attr):
                    entry[attr] = getattr(c, attr)
            if isinstance(c.value, str) and os.path.isfile(c.value):
                entry["url"] = "/file?path=" + urllib.parse.quote(c.value)
            out.append(entry)
        return out

    def apply_sets(self, sets: Dict[str, Any]):
        # TWO phases — vet everything, then assign: a PermissionError after
        # partial assignment would leave smuggled half-applied state behind
        # a response that claims nothing happened
        staged = []
        for key, value in sets.items():
            comp = self._component(key)
            # vet EVERY string inside the value, however nested: file_allowed
            # later trusts list/tuple component values too, so a bare-string
            # gate alone would let {"value": ["/etc/passwd"]} smuggle a path
            # into the serving allowlist
            for s in _iter_strings(value):
                if s and not self._set_path_ok(s):
                    raise PermissionError(
                        f"refusing client-set path for component {key}: {s!r}"
                    )
            value = _vet_client_type(comp, value)
            staged.append((comp, value))
        for comp, value in staged:
            comp.value = value

    def _set_path_ok(self, value: str) -> bool:
        """Client-set ABSOLUTE paths may not name existing files unless
        already servable (uploads, current component values, the map asset).

        Without this gate, POST /set could plant an on-disk path into a
        component value and GET /file would then serve it — ``file_allowed``
        trusts component values precisely because only the server's own
        handlers and vetted client sets can write them.  Relative strings
        pass freely: ``file_allowed`` ignores them (the server's own values
        are always absolute temp paths), so a textbox value that happens to
        name a file in the cwd ("bench.py" as a preset name) neither bricks
        the event path nor becomes servable.
        """
        if not os.path.isabs(value) or not os.path.isfile(value):
            return True
        return self.file_allowed(value)

    def ensure_listener(self, comp_id: int, event: str) -> "hl.Component":
        """Resolve (component, event) or raise UnknownRouteTarget — used to
        VALIDATE a request before any of its sets mutate server state, so a
        400 response really means nothing happened."""
        comp = self._component(comp_id)
        if not self.blocks.deps_for(comp, event):
            raise UnknownRouteTarget(f"no {event!r} listener on component {comp_id}")
        return comp

    def fire(self, comp_id: int, event: str, index=None, missing_ok: bool = False) -> bool:
        """Fire listeners on (component, event). Returns False when there is
        no such listener and ``missing_ok`` — never masks KeyErrors raised
        inside application handlers (those surface as handler errors)."""
        comp = self._component(comp_id)
        if not self.blocks.deps_for(comp, event):
            if missing_ok:
                return False
            raise UnknownRouteTarget(f"no {event!r} listener on component {comp_id}")
        event_data = None
        if event == "select":
            event_data = hl.SelectData(index=tuple(index) if index else None)
        self._touch_inputs(comp, event)
        self.blocks.fire(comp, event, event_data)
        return True

    def _touch_inputs(self, comp: "hl.Component", event: str):
        """Mark every upload that this event's handlers are about to read as
        used (``allowed()`` is a read-only gate in the port's store; reading
        an upload is what keeps it, as in the job API)."""
        for dep in self.blocks.deps_for(comp, event):
            for c in dep.inputs:
                for s in _iter_strings(c.value):
                    if s and os.path.isabs(s):
                        self._uploads.touch(os.path.realpath(s))

    # --- uploads / downloads ---
    def save_upload(self, filename: str, body: bytes) -> str:
        # single shared definition of the sanitize/claim/allowlist logic
        # (utils.uploads — also used by the render service)
        return self._uploads.save(filename, body)

    def file_allowed(self, path: str) -> bool:
        """Only uploads, current component values, and the map assets are
        servable — never arbitrary filesystem reads."""
        real = os.path.realpath(path)
        if self._uploads.allowed(real):
            return True
        allowed = {os.path.realpath(config.BASE_SURROUND_MAP_PATH)}
        for c in self.blocks.components:
            vals = c.value if isinstance(c.value, (list, tuple)) else [c.value]
            for v in vals:
                # ABSOLUTE component values only: the server's own handlers
                # always produce absolute temp paths, while relative strings
                # are user text (preset names …) that must never make a
                # same-named cwd file servable
                if isinstance(v, str) and v and os.path.isabs(v):
                    allowed.add(os.path.realpath(v))
        return real in allowed

    # --- request handler ---
    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # route to logging, not stderr
                log.debug("%s %s", self.address_string(), fmt % args)

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, obj: Any, code: int = 200):
                self._send(code, json.dumps(obj).encode("utf-8"),
                           "application/json; charset=utf-8")

            def _read_body(self) -> bytes:
                length = int(self.headers.get("Content-Length") or 0)
                if length < 0:
                    # rfile.read(-1) would read until the CLIENT closes —
                    # a hostile keep-alive socket that never sends pins
                    # this handler thread forever
                    self.close_connection = True
                    raise ValueError(f"invalid Content-Length {length}")
                if length > _MAX_UPLOAD:
                    # the unread body would desync this keep-alive
                    # connection (HTTP/1.1): the next "request line" parsed
                    # would be raw audio bytes — drop the connection instead
                    self.close_connection = True
                    raise ValueError(f"body too large ({length} bytes)")
                return self.rfile.read(length)

            # --- GET ---
            def do_GET(self):
                try:
                    self._do_get()
                except _CLIENT_GONE:
                    self.close_connection = True
                except (ValueError, OSError):
                    # hostile path bytes (embedded NUL → ValueError from
                    # os.path.isfile) or a file racing away between the
                    # isfile check and open — the clean error contract,
                    # not an unclean connection drop
                    self._send_json({"error": "not found"}, 404)
                except Exception as e:  # noqa: BLE001 — handler errors → 500
                    log.exception("GET failed")
                    self._send_json({"error": f"{type(e).__name__}: {e}"}, 500)

            def _do_get(self):
                parsed = urllib.parse.urlparse(self.path)
                if parsed.path == "/":
                    page = render_page(server.blocks)
                    self._send(200, page.encode("utf-8"), "text/html; charset=utf-8")
                elif parsed.path == "/state":
                    # NO event lock: a state poll must not hang for the
                    # whole duration of a render another thread is holding
                    # the lock for (the module's threading contract).
                    # Component attributes are plain Python objects; a poll
                    # during an event may see a transiently mixed view,
                    # which is fine for a status snapshot.
                    state = server.component_state()
                    self._send_json({"components": state})
                elif parsed.path == "/file":
                    qs = urllib.parse.parse_qs(parsed.query)
                    path = (qs.get("path") or [""])[0]
                    if not path or not os.path.isfile(path):
                        self._send_json({"error": "not found"}, 404)
                        return
                    if not server.file_allowed(path):
                        self._send_json({"error": "forbidden"}, 403)
                        return
                    ext = os.path.splitext(path)[1].lower()
                    # stream — hour-scale WAV results are hundreds of MB;
                    # reading them whole per request could exhaust the host
                    with open(path, "rb") as fh:
                        self.send_response(200)
                        self.send_header(
                            "Content-Type",
                            _CONTENT_TYPES.get(ext, "application/octet-stream"),
                        )
                        self.send_header(
                            "Content-Length", str(os.fstat(fh.fileno()).st_size)
                        )
                        self.send_header(
                            "Content-Disposition",
                            f'inline; filename="{os.path.basename(path)}"',
                        )
                        self.end_headers()
                        import shutil

                        try:
                            shutil.copyfileobj(fh, self.wfile, length=1 << 20)
                        except OSError:  # incl. client-gone subclasses
                            # headers are already on the wire — a JSON error
                            # response here would corrupt the stream; just
                            # drop the connection (the client sees a short
                            # body against the declared Content-Length)
                            self.close_connection = True
                else:
                    self._send_json({"error": "not found"}, 404)

            # --- POST ---
            def do_POST(self):
                parsed = urllib.parse.urlparse(self.path)
                try:
                    if parsed.path == "/upload":
                        body = self._read_body()
                        # the client percent-encodes the name: raw fetch()
                        # headers must be Latin-1, so a CJK/emoji filename
                        # would otherwise never reach us
                        filename = urllib.parse.unquote(
                            self.headers.get("X-Filename", "upload.bin")
                        )
                        path = server.save_upload(filename, body)
                        self._send_json({"path": path})
                        return
                    payload = json.loads(self._read_body() or b"{}")
                    if not isinstance(payload, dict):
                        # json.loads returns lists/numbers/strings too;
                        # `"id" not in 5` is a TypeError → 500 (the same
                        # fuzz-found class as the job API's bare-list body)
                        self._send_json(
                            {"error": "payload must be a JSON object"}, 400
                        )
                        return
                    if parsed.path in ("/set", "/event"):
                        if "id" not in payload:
                            self._send_json({"error": "missing 'id'"}, 400)
                            return
                        # coerce payload field TYPES here: int() of a JSON
                        # list, a dict used as an event name (unhashable
                        # lookup) or tuple() of a number all raise
                        # TypeError, which the catch-all below would turn
                        # into a 500 — payload shape is the client's fault
                        try:
                            cid = int(payload["id"])
                        except (TypeError, ValueError):
                            self._send_json(
                                {"error": "'id' must be an integer"}, 400
                            )
                            return
                        event = payload.get("event", "click")
                        if not isinstance(event, str):
                            self._send_json(
                                {"error": "'event' must be a string"}, 400
                            )
                            return
                        index = payload.get("index")
                        if index is not None and not (
                            isinstance(index, list)
                            and all(isinstance(v, (int, float)) for v in index)
                        ):
                            self._send_json(
                                {"error": "'index' must be a number list"}, 400
                            )
                            return
                        sets = payload.get("set") or {}
                        if not isinstance(sets, dict):
                            self._send_json(
                                {"error": "'set' must be a JSON object"}, 400
                            )
                            return
                    # serialize the response OUTSIDE the lock: a slow client
                    # draining wfile must not stall every other request
                    if parsed.path == "/set":
                        with server._lock:
                            server.apply_sets({cid: payload.get("value")})
                            if payload.get("fire_change"):
                                # no change listener → set alone is fine
                                server.fire(cid, "change", missing_ok=True)
                            state = server.component_state()
                        self._send_json({"components": state})
                    elif parsed.path == "/event":
                        with server._lock:
                            # validate the route BEFORE any set mutates
                            # state — a 400 must mean "nothing happened"
                            server.ensure_listener(cid, event)
                            server.apply_sets(sets)
                            server.fire(cid, event, index)
                            state = server.component_state()
                        self._send_json({"components": state})
                    else:
                        self._send_json({"error": "not found"}, 404)
                except UnknownRouteTarget as e:
                    self._send_json({"error": f"no such listener/component: {e}"}, 400)
                except PermissionError as e:
                    self._send_json({"error": str(e)}, 403)
                except (ValueError, json.JSONDecodeError) as e:
                    self._send_json({"error": str(e)}, 400)
                except _CLIENT_GONE:
                    # the client hung up while we were responding — there is
                    # no socket left to answer on, and it is not our error
                    self.close_connection = True
                except Exception as e:  # noqa: BLE001 — handler errors → 500 JSON
                    log.exception("event handler failed")
                    self._send_json({"error": f"{type(e).__name__}: {e}"}, 500)

        return Handler


# ---------------------------------------------------------------------------
# HTML page
# ---------------------------------------------------------------------------

_PAGE_CSS = """
body{font-family:system-ui,sans-serif;margin:0;background:#0f172a;color:#e2e8f0}
header{padding:12px 20px;background:#1e293b;font-size:18px;font-weight:600}
nav{display:flex;gap:4px;background:#1e293b;padding:0 12px;border-bottom:1px solid #334155}
nav button{background:none;border:none;color:#94a3b8;padding:10px 14px;cursor:pointer;font-size:14px;border-bottom:2px solid transparent}
nav button.active{color:#22d3ee;border-bottom-color:#22d3ee}
main{padding:16px 20px;max-width:1100px;margin:0 auto}
.tab{display:none;grid-template-columns:repeat(auto-fill,minmax(320px,1fr));gap:10px}
.tab.active{display:grid}
.comp{background:#1e293b;border-radius:8px;padding:10px 12px}
.comp label.lbl{display:block;font-size:12px;color:#94a3b8;margin-bottom:6px}
.comp input[type=range]{width:75%}
.comp select,.comp input[type=text],.comp input[type=number]{width:95%;background:#0f172a;color:#e2e8f0;border:1px solid #334155;border-radius:4px;padding:5px}
.comp button.action{background:#0891b2;color:#fff;border:none;border-radius:6px;padding:9px 14px;cursor:pointer;font-size:14px}
.comp button.action:disabled{opacity:.45}
.comp img{max-width:100%;border-radius:4px}
.comp audio{width:100%}
.md{background:none;padding:4px 2px;font-size:13px;line-height:1.45}
.val{font-size:12px;color:#22d3ee;margin-left:8px}
#busy{position:fixed;top:10px;right:16px;background:#0891b2;color:#fff;padding:6px 12px;border-radius:6px;display:none}
a{color:#22d3ee}
"""

_PAGE_JS = r"""
let state = [];
const el = id => document.querySelector(`[data-id="${id}"]`);

async function refresh(res) {
  const data = res || await (await fetch('/state')).json();
  state = data.components;
  for (const c of state) render(c);
}

function render(c) {
  const root = el(c.id);
  if (!root) return;
  root.style.display = c.visible ? '' : 'none';
  const input = root.querySelector('.ctl');
  if (input) {
    if (input.type === 'checkbox') input.checked = !!c.value;
    else if (input.tagName === 'SELECT') {
      if (c.choices) {
        const cur = Array.from(input.options).map(o => o.value).join('|');
        if (cur !== c.choices.join('|')) {
          input.innerHTML = '';
          for (const ch of c.choices) {
            const o = document.createElement('option');
            o.value = ch; o.textContent = ch; input.appendChild(o);
          }
        }
      }
      input.value = c.value == null ? '' : c.value;
    } else if (input.type !== 'file' && document.activeElement !== input) {
      // file inputs are render-only here: assigning a non-empty string to
      // <input type=file>.value throws InvalidStateError and would abort
      // the whole refresh loop
      input.value = c.value == null ? '' : c.value;
    }
    input.disabled = !c.interactive;
    const v = root.querySelector('.val');
    if (v) v.textContent = c.value;
  }
  const btn = root.querySelector('button.action');
  if (btn) btn.disabled = !c.interactive;
  const md = root.querySelector('.md-body');
  if (md) md.textContent = c.value == null ? '' : String(c.value);
  const img = root.querySelector('img');
  if (img && c.url && img.dataset.src !== c.url) {
    img.dataset.src = c.url; img.src = c.url + '&t=' + Date.now();
  }
  const audio = root.querySelector('audio');
  if (audio && c.url && audio.dataset.src !== c.url) {
    audio.dataset.src = c.url; audio.src = c.url;
  }
  const link = root.querySelector('a.dl');
  if (link) {
    if (c.url) { link.href = c.url; link.style.display = ''; link.download = ''; }
    else link.style.display = 'none';
  }
}

function collectSets() {
  const sets = {};
  for (const c of state) {
    const root = el(c.id); if (!root) continue;
    const input = root.querySelector('.ctl'); if (!input) continue;
    if (input.type === 'checkbox') sets[c.id] = input.checked;
    else if (input.type === 'range' || input.type === 'number')
      sets[c.id] = parseFloat(input.value);
    else if (input.dataset.filepath !== undefined) {
      // only send a file value the CLIENT chose; an empty filepath must not
      // null out server-set values (rendered results, download links)
      if (input.dataset.filepath) sets[c.id] = input.dataset.filepath;
    }
    else sets[c.id] = input.value;
  }
  return sets;
}

async function post(url, payload) {
  busy(true);
  try {
    const res = await fetch(url, {method: 'POST', body: JSON.stringify(payload)});
    const data = await res.json();
    if (data.error) { alert(data.error); return; }
    await refresh(data);
  } catch (e) { alert('Request failed: ' + e); }
  finally { busy(false); }
}

function busy(on) { document.getElementById('busy').style.display = on ? 'block' : 'none'; }

async function fireEvent(id, event, index) {
  await post('/event', {id, event, index, set: collectSets()});
}

async function setValue(id, value, fireChange) {
  await post('/set', {id, value, fire_change: !!fireChange});
}

async function uploadFile(id, fileInput) {
  const f = fileInput.files[0]; if (!f) return;
  busy(true);
  try {
    // percent-encode: raw header values must be Latin-1, so a CJK/emoji
    // filename would make fetch() throw synchronously with no feedback
    const res = await fetch('/upload', {method: 'POST', body: f,
      headers: {'X-Filename': encodeURIComponent(f.name)}});
    const data = await res.json();
    if (data.error) { alert(data.error); return; }
    const root = el(id);
    const ctl = root.querySelector('.ctl');
    if (ctl) ctl.dataset.filepath = data.path;
    await setValue(id, data.path, hasEvent(id, 'change'));
  } finally { busy(false); }
}

function hasEvent(id, ev) {
  const c = state.find(c => c.id === id);
  return c && c.events.includes(ev);
}

function mapClick(id, img, e) {
  const r = img.getBoundingClientRect();
  const x = Math.round((e.clientX - r.left) * img.naturalWidth / r.width);
  const y = Math.round((e.clientY - r.top) * img.naturalHeight / r.height);
  fireEvent(id, 'select', [x, y]);
}

function showTab(i, btn) {
  document.querySelectorAll('.tab').forEach(t => t.classList.remove('active'));
  document.querySelectorAll('nav button').forEach(b => b.classList.remove('active'));
  document.getElementById('tab' + i).classList.add('active');
  btn.classList.add('active');
}

refresh();
"""


def _render_component(c: "hl.Component", cid: int, events) -> str:
    """One component → HTML block (data-id wires it to the JS client)."""
    lbl = html.escape(str(c.label or ""))
    t = type(c).__name__
    head = f'<div class="comp" data-id="{cid}">'
    label_html = f'<label class="lbl">{lbl}</label>' if c.label else ""
    if t == "Markdown" or t == "Label":
        body = f'<div class="md md-body">{html.escape(str(c.value or ""))}</div>'
        return f'{head}{body}</div>'
    if t == "Button":
        return (
            f'{head}<button class="action" '
            f"onclick=\"fireEvent({cid},'click')\">{lbl}</button></div>"
        )
    if t == "Slider":
        if "input" in events:
            action = f"fireEvent({cid},'input')"
        else:
            action = f"setValue({cid},parseFloat(this.value))"
        step = c.step if c.step is not None else "any"
        return (
            f"{head}{label_html}"
            f'<input class="ctl" type="range" min="{c.minimum}" max="{c.maximum}" '
            f'step="{step}" value="{c.value}" '
            "oninput=\"this.parentNode.querySelector('.val').textContent=this.value\" "
            f'onchange="{action}">'
            f'<span class="val">{c.value}</span></div>'
        )
    if t == "Dropdown":
        opts = "".join(
            f'<option value="{html.escape(str(ch))}"'
            + (" selected" if ch == c.value else "")
            + f">{html.escape(str(ch))}</option>"
            for ch in (c.choices or [])
        )
        action = (
            f"fireEvent({cid},'change')" if "change" in events
            else f"setValue({cid},this.value)"
        )
        return f'{head}{label_html}<select class="ctl" onchange="{action}">{opts}</select></div>'
    if t == "Checkbox":
        action = (
            f"fireEvent({cid},'change')" if "change" in events
            else f"setValue({cid},this.checked)"
        )
        checked = " checked" if c.value else ""
        return (
            f'{head}<label><input class="ctl" type="checkbox"{checked} '
            f'onchange="{action}"> {lbl}</label></div>'
        )
    if t == "Textbox":
        return (
            f'{head}{label_html}<input class="ctl" type="text" '
            f'value="{html.escape(str(c.value or ""))}" '
            f'onchange="setValue({cid},this.value)"></div>'
        )
    if t == "Number":
        return (
            f'{head}{label_html}<input class="ctl" type="number" value="{c.value}" '
            f'onchange="setValue({cid},parseFloat(this.value))"></div>'
        )
    if t in ("Audio", "File"):
        player = '<audio controls data-src=""></audio>' if t == "Audio" else ""
        return (
            f'{head}{label_html}'
            f'<input class="ctl" type="file" data-filepath="" '
            f'onchange="uploadFile({cid},this)">{player}'
            f'<a class="dl" style="display:none">⬇ Download</a></div>'
        )
    if t == "Image":
        click = (
            f' onclick="mapClick({cid},this,event)" style="cursor:crosshair"'
            if "select" in events
            else ""
        )
        return f'{head}{label_html}<img data-src="" alt="{lbl}"{click}></div>'
    return f'{head}{label_html}<div class="md-body"></div></div>'


def render_page(blocks: "hl.Blocks") -> str:
    """The studio page: tabs → component blocks → inline JS client."""
    listeners = _listener_map(blocks)
    tabs: List[str] = []
    for c in blocks.components:
        if c.tab and c.tab not in tabs:
            tabs.append(c.tab)
    nav = "".join(
        f'<button class="{"active" if i == 0 else ""}" '
        f'onclick="showTab({i},this)">{html.escape(t)}</button>'
        for i, t in enumerate(tabs)
    )
    sections = []
    for i, tab in enumerate(tabs):
        blocks_html = "".join(
            _render_component(c, cid, listeners.get(cid, set()))
            for cid, c in enumerate(blocks.components)
            if c.tab == tab
        )
        active = " active" if i == 0 else ""
        sections.append(f'<div class="tab{active}" id="tab{i}">{blocks_html}</div>')
    title = html.escape(blocks.title or "Audio Raytracing Studio")
    return (
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>{title}</title><style>{_PAGE_CSS}</style></head>"
        f"<body><header>{title}</header><nav>{nav}</nav>"
        f"<div id='busy'>⏳ Verarbeitung läuft…</div>"
        f"<main>{''.join(sections)}</main>"
        f"<script>{_PAGE_JS}</script></body></html>"
    )


def serve(blocks: "hl.Blocks", host: str = "0.0.0.0", port: int = config.DEFAULT_SERVER_PORT):
    """Blocking serve — the launch() path (reference raytracer_studio.py:1397)."""
    server = StudioHTTPServer(blocks, host, port)
    print(f"* Audio Raytracing Studio läuft auf http://{host}:{server.port}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.stop()
