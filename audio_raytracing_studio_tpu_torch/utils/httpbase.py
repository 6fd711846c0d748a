"""HTTP-server base of the render service — the port's own copy of
``audio_raytracing_studio_tpu/utils/httpbase.py``.

The job API (``serving/service.py``) sits on the standard library's
``ThreadingHTTPServer``, whose default ``handle_error`` prints a full
traceback every time a client disconnects mid-response (BrokenPipeError /
ConnectionResetError — a cancelled result download, say).  Real handler
faults never reach ``handle_error``: the handlers catch them and answer with
a JSON error, so anything else is still reported.
"""

from __future__ import annotations

import sys
from http.server import ThreadingHTTPServer

# NOT TimeoutError: since 3.11 concurrent.futures.TimeoutError IS
# TimeoutError, and the job API's future.result(timeout=...) must never be
# taken for a disconnected client
_CLIENT_GONE = (BrokenPipeError, ConnectionResetError)


class QuietDisconnectHTTPServer(ThreadingHTTPServer):
    daemon_threads = True

    def handle_error(self, request, client_address):  # noqa: D102
        if isinstance(sys.exception(), _CLIENT_GONE):
            return  # the client hung up — not a server error
        super().handle_error(request, client_address)
