"""The port imports PyTorch and never JAX: every module of
audio_raytracing_studio_tpu_torch is imported in a fresh interpreter, which
must end with no ``jax`` module loaded and no module of the JAX package
(``audio_raytracing_studio_tpu`` or anything under it) — the port keeps its
own copies of ``config``, ``params``, ``metering.kweighting``, the float64
oracle and the JAX-free ``app`` modules.  Nor does importing the port pull in
matplotlib or PIL, which may be absent beside the card: the modules that draw
import them inside the functions that do.

The codecs' host libraries are the port's own: no port module names a path
under the JAX package's directory (which would let ctypes load a library
built there), and importing every module builds nothing — the libraries are
compiled from ``utils/_native/*.cc`` into ``_build/`` at first use."""

import ast

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
                     "tools.bench_serving", "tools.fuzz_campaign", "graft_entry",
                     "utils.flacio", "utils.vorbisio", "utils.vorbisenc", "utils.mp3io",
                     "utils.lavcio", "utils._native_pcm", "utils._native_flac",
                     "utils._native_vorbis", "utils._native_lavc", "tools.bench_codecs",
                     "parallel.mesh", "parallel.partitioned_conv",
                     "parallel.distributed_fft", "parallel.long_render",
                     "tools.dryrun_distributed", "ops.chirp"):
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


def string_constants(tree):
    """Every str literal of a module that is not a docstring."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            first = node.body[0] if node.body else None
            if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
                docs.add(id(first.value))
    return [n for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


def test_port_names_no_path_under_the_jax_package():
    jax_dir = "audio_raytracing_studio_tpu"
    bad = []
    for root, _dirs, files in os.walk(os.path.dirname(port.__file__)):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            with open(path) as f:
                tree = ast.parse(f.read())
            for node in string_constants(tree):
                v = node.value
                if v == jax_dir or f"{jax_dir}/" in v or f"{jax_dir}\\" in v:
                    bad.append(f"{os.path.relpath(path, REPO)}:{node.lineno}: {v[:80]!r}")
    assert not bad, bad


def test_importing_every_module_builds_no_host_library(tmp_path):
    """With ``kernels.BUILD_DIR`` pointed at an empty directory, importing
    every port module leaves it empty: nothing is compiled at import."""
    build = tmp_path / "_build"
    code = (
        "import importlib, pathlib, sys\n"
        "from audio_raytracing_studio_tpu_torch.utils import kernels\n"
        f"kernels.BUILD_DIR = pathlib.Path({str(build)!r})\n"
        f"for name in {port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "built = sorted(p.name for p in kernels.BUILD_DIR.glob('*')) "
        "if kernels.BUILD_DIR.exists() else []\n"
        "print(built)\n"
        "sys.exit(1 if built else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert not build.exists()


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
