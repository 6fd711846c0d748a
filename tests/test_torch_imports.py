"""The port imports PyTorch and never JAX: every module of
audio_raytracing_studio_tpu_torch is imported in a fresh interpreter, which
must end with no ``jax`` module loaded and no module of the JAX package
(``audio_raytracing_studio_tpu`` or anything under it) — the port keeps its
own copies of ``config``, ``params``, ``metering.kweighting``, the float64
oracle and the JAX-free ``app`` modules.  Nor does importing the port pull in
matplotlib or PIL, which may be absent beside the card: the modules that draw
import them inside the functions that do."""

import os
import pkgutil
import subprocess
import sys

import audio_raytracing_studio_tpu_torch as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_modules():
    names = [port.__name__]
    for info in pkgutil.walk_packages(port.__path__, prefix=port.__name__ + "."):
        names.append(info.name)
    return names


def test_every_port_module_is_listed():
    names = port_modules()
    for expected in ("ops.rng", "ops.ir_synth", "ops.ir_synth_cuda", "ops.convolution",
                     "ops.filters", "ops.spatial", "ops.resample", "metering.loudness",
                     "models.pipeline", "models.convert", "parallel.sharding",
                     "utils.kernels", "config", "params", "metering.kweighting",
                     "utils.runtime", "utils.wavio", "utils.presets", "analysis.metrics",
                     "ops.binaural", "cli.render", "cli.render_dir", "cli.analyzer",
                     "serving.batcher", "serving.service", "utils.uploads", "utils.httpbase",
                     "oracle.dsp", "oracle.loudness", "analysis.visualize",
                     "analysis.profiler", "app.marker", "app.api", "app._gradio_headless",
                     "app.server", "app.studio", "app.analyzer_ui", "__main__", "compat",
                     "parallel.streaming", "parallel.streaming_eq", "tools.bench_long",
                     "tools.profile_render", "utils.logging_config", "utils.watchdog",
                     "utils.profiling", "tools.bench", "tools.profile_exact",
                     "tools.bench_serving", "tools.fuzz_campaign", "graft_entry"):
        assert f"{port.__name__}.{expected}" in names


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'audio_raytracing_studio_tpu'\n"
        "             or m.startswith('audio_raytracing_studio_tpu.'))\n"
        "bad += sorted(m for m in sys.modules if m.split('.')[0] in ('matplotlib', 'PIL'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_imports_no_jax_and_needs_cuda():
    """chip_smoke.py imports the port only, and without a CUDA device it
    exits non-zero before printing any result line."""
    import ast

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    imported = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    imported += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert any(m.startswith("audio_raytracing_studio_tpu_torch") for m in imported)
    for m in imported:
        top = m.split(".")[0]
        assert top not in ("jax", "jaxlib", "audio_raytracing_studio_tpu"), m
    import torch

    if torch.cuda.is_available():
        return
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
