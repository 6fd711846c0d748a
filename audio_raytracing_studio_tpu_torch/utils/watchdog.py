"""No-progress watchdog for benches and long-running tools — port of
``audio_raytracing_studio_tpu/utils/watchdog.py`` (host-only, copied as it is).

A device or its driver can stop completing work with no error: a tool
blocked that way eats its caller's whole timeout and reports nothing.
``StallWatchdog`` samples a caller-supplied progress snapshot plus the
process's own I/O counters; if NEITHER changes for ``timeout_s`` it dumps
every Python thread's stack and runs ``on_stall`` — by default printing an
``"error"``-carrying JSON line and hard-exiting 3, so the caller sees a
structured failure in seconds, not a shell timeout in hours.

The I/O-counter signal (``/proc/self/io`` rchar+wchar) covers phases with
no job-level progress but real work in flight (a multi-hundred-MB upload,
a result download).  Reading ``/proc/self/io`` itself increments rchar by
~100 bytes, so raw inequality would reset the idle timer on every poll and
the watchdog could never fire; an I/O delta only counts as progress when it
exceeds ``io_epsilon`` bytes per poll — sized far above the self-read cost
and far below any real transfer.  A first call that builds kernels or
cuFFT plans can legitimately sit quiet for a while: callers doing that at a
new shape pass a generous ``timeout_s`` or disable the watchdog (``0``).
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Callable, Optional


def _io_bytes() -> int:
    """Total bytes read+written by this process (``/proc/self/io``).

    Returns -1 where the file is unavailable (non-Linux) — a constant, so
    the watchdog then keys on the caller's progress snapshot alone.
    """
    try:
        total = 0
        with open("/proc/self/io") as f:
            for line in f:
                key, _, val = line.partition(":")
                if key in ("rchar", "wchar"):
                    total += int(val)
        return total
    except (OSError, ValueError):
        return -1


class StallWatchdog:
    """Background thread that aborts the process when progress stops.

    Parameters
    ----------
    progress:   zero-arg callable returning any equality-comparable
                snapshot of forward progress (e.g. ``(jobs_done, batches)``
                from ``RenderService.stats()``).  Exceptions inside it are
                treated as "no change" rather than killing the watchdog.
    timeout_s:  abort once BOTH the snapshot and the process I/O counters
                are unchanged for this long.  ``0`` disables (``start()``
                becomes a no-op).
    on_stall:   override the abort action (tests).  The default prints the
                thread dump to stderr and ``os._exit(3)``.
    stall_json: optional dict printed to stdout as one JSON line with an
                added ``"error"`` key before the default abort — keeps the
                tool's one-JSON-line output contract even when it dies.
    io_epsilon: minimum I/O-counter delta (bytes) between two polls that
                counts as progress.  The watchdog's own ``/proc/self/io``
                read costs ~100 bytes of rchar per poll, so a zero epsilon
                makes the watchdog inert.  Default 64 KiB: orders of
                magnitude above the self-read tax plus incidental logging,
                orders of magnitude below a real upload/download.
    """

    def __init__(
        self,
        progress: Callable[[], object],
        *,
        timeout_s: float = 600.0,
        poll_s: float = 10.0,
        on_stall: Optional[Callable[[str], None]] = None,
        stall_json: Optional[dict] = None,
        name: str = "stall-watchdog",
        io_epsilon: int = 65536,
    ):
        self.progress = progress
        self.timeout_s = float(timeout_s)
        self.poll_s = float(poll_s)
        self.io_epsilon = int(io_epsilon)
        self.stall_json = stall_json
        self.on_stall = on_stall or self._default_on_stall
        self.name = name
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # --- lifecycle (context-manager friendly) ---
    def start(self) -> "StallWatchdog":
        if self.timeout_s > 0 and self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name=self.name, daemon=True
            )
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.poll_s + 1.0)
            self._thread = None

    def __enter__(self) -> "StallWatchdog":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # --- internals ---
    def _progress_snapshot(self):
        try:
            return self.progress()
        except Exception:  # noqa: BLE001 — a flaky probe must not kill us
            return None

    def _run(self):
        last_prog = self._progress_snapshot()
        last_io = _io_bytes()
        t_last = time.monotonic()
        while not self._stop.wait(self.poll_s):
            cur_prog = self._progress_snapshot()
            cur_io = _io_bytes()
            # The io read itself moves rchar (~100 B/poll) — only a delta
            # beyond io_epsilon is real work, not our own measurement tax.
            io_moved = (
                cur_io >= 0
                and last_io >= 0
                and abs(cur_io - last_io) >= self.io_epsilon
            )
            last_io = cur_io
            if cur_prog != last_prog or io_moved:
                last_prog = cur_prog
                t_last = time.monotonic()
                continue
            idle = time.monotonic() - t_last
            if idle < self.timeout_s:
                continue
            msg = (
                f"{self.name}: no progress for {idle:.0f} s "
                f"(progress snapshot and process I/O both frozen) — "
                f"aborting; a device or driver that stopped completing work "
                f"is the usual cause"
            )
            self.on_stall(msg)
            return

    def _default_on_stall(self, msg: str):
        import faulthandler
        import json
        import os

        print(msg, file=sys.stderr)
        faulthandler.dump_traceback(file=sys.stderr)
        if self.stall_json is not None:
            print(json.dumps({**self.stall_json, "error": msg}))
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(3)
