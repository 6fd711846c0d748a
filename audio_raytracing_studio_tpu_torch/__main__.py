"""`python -m audio_raytracing_studio_tpu_torch [--device cuda|cpu] [--port N]`
launches the studio — the same entry habit as the reference's
`python raytracer_studio.py` (raytracer_studio.py:1387-1397): ensure
presets/map assets, then serve the 4-tab UI on 0.0.0.0:8861 (gradio when
installed, else the package's stdlib HTTP server).  Without `--device` the
studio runs on `ARS_TORCH_DEVICE` or CUDA; CUDA without a card exits 1 naming
it, before any port is bound."""

import argparse
import sys

from . import config
from .app.studio import main as studio_main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m audio_raytracing_studio_tpu_torch",
                                 description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: ARS_TORCH_DEVICE, else cuda; "
                         "cpu runs the plain PyTorch path)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=config.DEFAULT_SERVER_PORT)
    args = ap.parse_args(argv)
    try:
        studio_main(server_name=args.host, server_port=args.port, device=args.device)
    except RuntimeError as e:  # no card for a CUDA device
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
