"""v4 JSON preset persistence — the port's own copy of
``audio_raytracing_studio_tpu/utils/presets.py`` over its own ``config`` and
``params`` (the files either package writes are byte-identical and load in
the other).

Contract (the reference's raytracer_studio.py:45-80, :864-988):
- presets live as ``<safe_name>_v4.json`` files in ``presets_v4/``,
- exactly the 16 ordered keys of config.PRESET_KEYS plus ``_source_name``
  and ``_version`` metadata,
- filename sanitization keeps alnum/space/underscore/dash, spaces → ``_``,
- the last-used preset filename persists in ``presets_v4/last_preset_v4.txt``
  and is validated on load,
- loading coerces bool/float per key with per-key defaults,
- deletion invalidates the last-used pointer; ZIP export bundles all presets.
"""

from __future__ import annotations

import json
import os
import tempfile
import zipfile
from typing import List, Optional, Tuple

from .. import config
from ..params import RenderParams


class PresetStore:
    """Filesystem-backed preset CRUD rooted at ``base_dir``."""

    def __init__(self, base_dir: str = ".") -> None:
        self.preset_dir = os.path.join(base_dir, config.PRESET_DIR)
        self.last_preset_file = os.path.join(
            self.preset_dir, config.LAST_PRESET_FILENAME
        )

    # --- directory / last-used bookkeeping (ref :47-80) ---

    def ensure_dir(self) -> None:
        os.makedirs(self.preset_dir, exist_ok=True)

    def save_last(self, preset_name: Optional[str]) -> None:
        self.ensure_dir()
        name = preset_name if isinstance(preset_name, str) else ""
        with open(self.last_preset_file, "w", encoding="utf-8") as f:
            f.write(name)

    def load_last(self) -> Optional[str]:
        self.ensure_dir()
        if not os.path.exists(self.last_preset_file):
            return None
        with open(self.last_preset_file, "r", encoding="utf-8") as f:
            last = f.read().strip()
        if not last:
            return None
        path = self._member_path(last)
        if path is not None and os.path.exists(path):
            return last
        self.save_last("")  # invalid reference → clear (ref :75-77)
        return None

    # --- CRUD (ref :864-988) ---

    @staticmethod
    def _safe_base(stripped_name: str) -> str:
        """The reference's pre-underscore ``safe_filename_base`` (ref :874):
        filtered to alnum/space/_/- and stripped, SPACES STILL PRESENT —
        both the filename and the ``_source_name`` comparison derive from
        this exact intermediate."""
        return "".join(
            c for c in stripped_name if c.isalnum() or c in (" ", "_", "-")
        ).strip()

    @staticmethod
    def sanitize_name(preset_name: str) -> Optional[str]:
        """``<safe>_v4.json`` filename or None if nothing survives (ref :874-876)."""
        preset_name = preset_name.strip() if isinstance(preset_name, str) else ""
        if not preset_name:
            return None
        base = PresetStore._safe_base(preset_name)
        filename = base.replace(" ", "_") + "_v4.json"
        if not base or filename == "_v4.json":
            return None
        if len(filename.encode("utf-8")) > 255:
            # common filesystem name limit: open() would raise
            # ENAMETOOLONG (an OSError the HTTP error contract maps to
            # 500, not the clean 400 of an invalid name — fuzz-found,
            # tools/fuzz_campaign.py preset mode)
            return None
        return filename

    def list_presets(self) -> List[str]:
        """Sorted case-insensitive preset filenames (ref :864-868)."""
        self.ensure_dir()
        try:
            return sorted(
                (f for f in os.listdir(self.preset_dir) if f.endswith(".json")),
                key=str.lower,
            )
        except OSError:
            return []

    def save(self, preset_name: str, params: RenderParams) -> Tuple[str, str]:
        """Persist params → (status message, saved filename).

        Raises ValueError on an unusable name (ref :873-876 returns a warning
        string; callers map the exception to their UI).
        """
        self.ensure_dir()
        filename = self.sanitize_name(preset_name)
        if filename is None:
            raise ValueError("invalid preset name")
        path = os.path.join(self.preset_dir, filename)

        data = params.to_preset_dict()
        # the reference compares the PRE-underscore safe base against the
        # STRIPPED name (ref :891): "My Preset" keeps _source_name null —
        # comparing the filename base ("My_Preset") here would write the
        # name for every spaced preset, different JSON bytes
        stripped = preset_name.strip() if isinstance(preset_name, str) else ""
        data["_source_name"] = (
            stripped if self._safe_base(stripped) != stripped else None
        )
        data["_version"] = config.APP_VERSION

        with open(path, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=4, ensure_ascii=False)
        self.save_last(filename)
        return f"Preset '{filename}' gespeichert!", filename

    def _member_path(self, preset_file: str) -> Optional[str]:
        """Resolve a preset FILENAME inside preset_dir, or None if unusable.

        Frontends (the HTTP studio serves 0.0.0.0) pass client-controlled
        strings here — anything that is not a bare ``*.json`` basename is
        refused so ``"../README.md"`` can never read or delete files
        outside the preset directory.
        """
        name = preset_file if isinstance(preset_file, str) else ""
        if (
            not name
            or name != os.path.basename(name)
            or "/" in name
            or "\\" in name
            or name in (".", "..")
            or not name.endswith(".json")
            or len(name.encode("utf-8")) > 255
        ):
            # the length bound keeps open() from raising ENAMETOOLONG —
            # an OSError, where a bad name must be ValueError/not-found
            return None
        return os.path.join(self.preset_dir, name)

    def load(self, preset_file: str, remember: bool = True) -> RenderParams:
        """Load + coerce a preset file (ref :901-932). Raises on missing file
        and on traversal-shaped names.

        ``remember=False`` skips the last-used pointer update — the render
        service reads presets without mutating the studio's UI state."""
        path = self._member_path(preset_file)
        if path is None:
            raise ValueError(f"invalid preset filename: {preset_file!r}")
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
        if remember:
            self.save_last(preset_file)
        return RenderParams.from_preset_dict(data)

    def delete(self, preset_file: str) -> bool:
        """Delete; clears the last-used pointer if it referenced it (ref :934-946).
        Traversal-shaped names are treated as not-found."""
        path = self._member_path(preset_file)
        if path is None or not os.path.exists(path):
            return False
        os.remove(path)
        if self.load_last() == preset_file:
            self.save_last("")
        return True

    def export_zip(self, zip_path: Optional[str] = None) -> Optional[str]:
        """Bundle every preset JSON into a ZIP; None when there is nothing
        to export (ref :948-988)."""
        self.ensure_dir()
        files = [f for f in os.listdir(self.preset_dir) if f.endswith(".json")]
        if not files:
            return None
        if zip_path is None:
            fd, zip_path = tempfile.mkstemp(
                suffix="_presets_v4.zip", prefix="audio_studio_"
            )
            os.close(fd)
        try:
            with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as zf:
                for filename in files:
                    zf.write(os.path.join(self.preset_dir, filename), arcname=filename)
        except Exception:
            if os.path.exists(zip_path):
                os.remove(zip_path)
            raise
        return zip_path
