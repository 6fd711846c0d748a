"""Upload store of the HTTP render service — the port's own copy of
``audio_raytracing_studio_tpu/utils/uploads.py``.

One definition of what the service's file gate trusts: filename
sanitization, the atomic O_CREAT|O_EXCL name claim (concurrent uploads of
one name must not collide), and the realpath allowlist.

Unlike the JAX package's store, the gate check ``allowed()`` is a read-only
membership test: it never reorders the LRU, so a probe of the gate cannot
steer which upload is evicted next.  A job that reads an upload marks it
used with ``touch()``.
"""

from __future__ import annotations

import os
import re
import shutil
import tempfile
import threading
from collections import OrderedDict
from typing import Optional


class UploadStore:
    """Temp-dir upload store with an LRU-ordered realpath allowlist.

    ``max_files`` bounds the store: the least-recently-USED uploads are
    unlinked and dropped from the allowlist once the cap is exceeded, so a
    long-running service stays disk-bounded (None keeps everything).  A
    shared upload that jobs keep referencing (upload one IR, submit many
    jobs) is ``touch()``ed by each of them and so outlives a stream of newer
    one-shot uploads.
    """

    def __init__(self, prefix: str, max_files: Optional[int] = None):
        if max_files is not None and max_files < 1:
            raise ValueError(f"max_files must be >= 1 (got {max_files})")
        self.dir = tempfile.mkdtemp(prefix=prefix)
        self.max_files = max_files
        self._lock = threading.Lock()
        self._paths: "OrderedDict[str, None]" = OrderedDict()

    def save(self, filename: str, body: bytes) -> str:
        """Sanitize ``filename``, claim a unique name atomically, write the
        body, and add the file to the allowlist.  Returns the path."""
        base = os.path.basename(filename) or "upload.bin"
        base = re.sub(r"[^A-Za-z0-9._\-]", "_", base)
        path = os.path.join(self.dir, base)
        stem, ext = os.path.splitext(path)
        n = 1
        # O_CREAT|O_EXCL makes the name claim atomic: uploads run on the
        # server's handler threads without a lock, so an exists()-then-open
        # sequence would let two concurrent uploads of one name collide
        while True:
            try:
                fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
                break
            except FileExistsError:
                path = f"{stem}_{n}{ext}"
                n += 1
        with os.fdopen(fd, "wb") as fh:
            fh.write(body)
        evicted = []
        with self._lock:
            self._paths[os.path.realpath(path)] = None
            if self.max_files is not None:
                while len(self._paths) > self.max_files:
                    old, _ = self._paths.popitem(last=False)
                    evicted.append(old)
        for old in evicted:
            try:
                os.unlink(old)
            except OSError:
                pass
        return path

    def allowed(self, realpath: str) -> bool:
        """Read-only membership test against the allowlist (the caller
        passes a realpath); the LRU order is left alone."""
        with self._lock:
            return realpath in self._paths

    def touch(self, realpath: str) -> bool:
        """Mark an allowed file most-recently-used (a job is reading it);
        False, and nothing changes, when it is not in the allowlist."""
        with self._lock:
            if realpath in self._paths:
                self._paths.move_to_end(realpath)
                return True
            return False

    def cleanup(self):
        """Remove the upload directory and clear the allowlist."""
        shutil.rmtree(self.dir, ignore_errors=True)
        with self._lock:
            self._paths.clear()
