"""The render graph's back half: dry/wet mix, the optional shelf EQ, three
conditional peak normalizations, the 3D pan and the layout map
(raytracer_studio.py:338-571; ``models.pipeline._mix_eq_spatial`` in the
JAX package).

Two producers of the same (B, channels, n) result:

- the hand-written CUDA kernels of ``csrc/back_half.cu`` (route: nvcc →
  ctypes), launched for CUDA tensors by ``back_half``: a few streaming
  passes that keep every intermediate (the padded dry signal, the six panned
  channels, the ``abs`` temporaries) in registers, bit-equal to the plain
  version;
- ``back_half_plain``, the staged PyTorch ops (mix → EQ → normalize → pan →
  normalize → map → normalize), used for CPU tensors and as the kernels'
  reference.

A CUDA tensor never takes the plain path: the kernels launch or the call
raises.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Callable, Optional, Tuple

import torch

from .. import config
from ..utils import profiling
from . import filters, spatial

N_COEFS = 16  # per-clip table width; csrc/back_half.cu kCoefs
N_SLOTS = 6  # per-clip maxima scratch; csrc/back_half.cu kSlots
# csrc/back_half.cu's layout codes: 7.1 and 5.1.2 share one body (the rear
# pair delayed and scaled), with their own delay and gain
LAYOUT_CODES = {"Stereo": 0, "5.1 (Standard)": 1, "7.1 (Surround)": 2, "5.1.2 (Atmos Light)": 2}

# Back-half calls that launched the CUDA kernels in this process (one per
# call, every pass and the EQ's mix together); the plain path never counts.
# Render threads launch concurrently, so ``_count`` adds under a lock.
launch_count = 0
_count_lock = threading.Lock()

EQ = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _count() -> None:
    global launch_count
    with _count_lock:
        launch_count += 1
    if profiling.spans_on():
        profiling.counter_add("ars.back_half_kernels", 1)


def _layout_name(layout: str) -> str:
    return layout if layout in config.CHANNEL_LAYOUTS else config.DEFAULT_CHANNEL_LAYOUT


def back_half_plain(
    audio: torch.Tensor, wet: torch.Tensor, scal, layout: str, rate: int, eq: EQ = None
) -> torch.Tensor:
    """The staged PyTorch back half → (B, channels, n).

    audio (B, 2, n_in) with n_in ≤ n, zero past its end; wet (B, 2, n);
    ``scal``: the per-clip (B,) float32 mix scalars (``pipeline.MixScalars``);
    ``eq``: applied to the mix before the first normalization, or None.
    """
    dry = torch.nn.functional.pad(audio, (0, wet.shape[-1] - audio.shape[-1]))
    dry_coef = scal.dry_factor * (1.0 - scal.dry_wet)
    mixed = dry_coef[:, None, None] * dry + scal.dry_wet[:, None, None] * wet
    if eq is not None:
        mixed = eq(mixed)
    mixed = filters.conditional_peak_normalize(mixed)

    six = spatial.apply_pan(mixed, spatial.pan_matrix(scal.x_pos, scal.y_pos, scal.z_pos))
    six = filters.conditional_peak_normalize(six)

    out = spatial.map_layout(six, layout, rate, scal.z_pos)
    return filters.conditional_peak_normalize(out)


def coefficients(scal, layout: str, rate: int) -> Tuple[torch.Tensor, int, int]:
    """The kernels' per-clip table, layout code and delay → ((B, N_COEFS)
    float32, code, delay in samples).

    Columns: the dry coefficient ``dry_factor·(1 − dry_wet)``, ``dry_wet``,
    ``pan_matrix``'s L row then its R row ([FL, FR, C, LFE, RL, RR]), and
    two map gains — Stereo the centre and rear downmix gains, 7.1 the side
    gain, 5.1.2 the clip's height gain, 5.1 none (zeros).  Each is computed
    by the same PyTorch ops as in ``back_half_plain``, on the same device,
    so the kernels multiply by the plain version's float32 values.
    """
    layout = _layout_name(layout)
    dry_wet = scal.dry_wet
    dry_coef = scal.dry_factor * (1.0 - dry_wet)
    pan = spatial.pan_matrix(scal.x_pos, scal.y_pos, scal.z_pos).reshape(-1, 12)
    zero = torch.zeros_like(dry_wet)
    delay = 0
    if layout == "Stereo":
        gains = (torch.full_like(dry_wet, config.DOWNMIX_CENTER_GAIN),
                 torch.full_like(dry_wet, config.DOWNMIX_REAR_GAIN))
    elif layout == "7.1 (Surround)":
        delay = int(rate * config.SIDE_DELAY_MS / 1000)
        gains = (torch.full_like(dry_wet, config.SIDE_GAIN), zero)
    elif layout == "5.1.2 (Atmos Light)":
        delay = int(rate * config.HEIGHT_DELAY_MS / 1000)
        gains = (scal.z_pos.clamp(0.0, 1.0) * config.HEIGHT_Z_GAIN, zero)
    else:
        gains = (zero, zero)
    table = torch.cat([dry_coef[:, None], dry_wet[:, None], pan,
                       gains[0][:, None], gains[1][:, None]], dim=1)
    return table, LAYOUT_CODES[layout], max(0, delay)


@functools.lru_cache(maxsize=None)
def _launchers():
    """Build (at first use) and bind both launchers of csrc/back_half.cu."""
    from ..utils import kernels

    lib = kernels.load("back_half")
    ll, ptr = ctypes.c_longlong, ctypes.c_void_p
    rows = [ptr, ll, ll, ll, ptr, ll, ll]  # dry, its strides and length, src, its strides
    passes = lib.back_half_launch
    passes.restype = ctypes.c_int
    passes.argtypes = rows + [ptr, ptr, ptr, ctypes.c_int, ll, ctypes.c_int, ll, ctypes.c_int,
                              ptr]  # coef, out, stats, batch, n, layout, delay, mix, stream
    mix = lib.back_half_mix_launch
    mix.restype = ctypes.c_int
    mix.argtypes = rows + [ptr, ptr, ctypes.c_int, ll, ptr]  # coef, out, batch, n, stream
    return passes, mix


def _rows(name: str, x: torch.Tensor, batch: int, device) -> torch.Tensor:
    """``x`` as the kernels read it: (B, 2, n) float32 on ``device``, any
    batch and channel strides, unit stride along the samples (else a
    contiguous copy)."""
    if (x.device != device or x.dtype != torch.float32 or x.dim() != 3
            or x.shape[0] != batch or x.shape[1] != 2):
        raise ValueError(
            f"back_half takes {name} as a (B={batch}, 2, n) float32 tensor on {device}, "
            f"got {tuple(x.shape)} {x.dtype} on {x.device}"
        )
    return x if x.stride(-1) == 1 else x.contiguous()


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {err}")


def _back_half_cuda(
    audio: torch.Tensor, wet: torch.Tensor, scal, layout: str, rate: int, eq: EQ
) -> torch.Tensor:
    """Launch csrc/back_half.cu on the current stream of ``wet``'s card →
    (B, channels, n), with no host sync."""
    device = wet.device
    batch, n = wet.shape[0], wet.shape[-1]
    wet = _rows("wet", wet, batch, device)
    audio = _rows("audio", audio, batch, device)
    if audio.shape[-1] > n or n == 0:
        raise ValueError(f"back_half needs 0 < n_in ≤ n, got n_in={audio.shape[-1]}, n={n}")
    table, code, delay = coefficients(scal, layout, rate)
    if table.device != device or table.dtype != torch.float32 or table.shape != (batch, N_COEFS):
        raise ValueError(f"mix scalars must be (B={batch},) float32 tensors on {device}, got "
                         f"a table {tuple(table.shape)} {table.dtype} on {table.device}")
    channels = len(config.CHANNEL_LAYOUTS[_layout_name(layout)]["names"])
    passes, mix = _launchers()
    dry_args = (audio.data_ptr(), audio.stride(0), audio.stride(1), audio.shape[-1])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        src = wet
        if eq is not None:
            mixed = torch.empty((batch, 2, n), dtype=torch.float32, device=device)
            _raise_on(mix(*dry_args, wet.data_ptr(), wet.stride(0), wet.stride(1),
                          table.data_ptr(), mixed.data_ptr(), batch, n, stream),
                      "back_half_mix")
            src = _rows("the EQ's output", eq(mixed), batch, device)
            if src.shape[-1] != n:
                raise ValueError(f"the EQ changed the length {n} to {src.shape[-1]}")
        out = torch.empty((batch, channels, n), dtype=torch.float32, device=device)
        stats = torch.empty((batch, N_SLOTS), dtype=torch.int32, device=device)
        _raise_on(passes(*dry_args, src.data_ptr(), src.stride(0), src.stride(1),
                         table.data_ptr(), out.data_ptr(), stats.data_ptr(), batch, n, code,
                         delay, int(eq is None), stream),
                  "back_half")
    _count()
    return out


def back_half(
    audio: torch.Tensor, wet: torch.Tensor, scal, layout: str, rate: int, eq: EQ = None
) -> torch.Tensor:
    """Mix, EQ, normalize, pan, normalize, map, normalize → (B, channels, n)
    float32 (``back_half_plain``'s arguments).

    The device of ``wet`` picks the producer: the CUDA kernels on a card
    (each call counted once in ``launch_count``, and in the program counter
    ``ars.back_half_kernels`` while spans are on), the plain version on the
    CPU.  With ``eq``, the kernels write the mix, ``eq`` runs on it, and the
    rest reads its output.
    """
    if wet.device.type == "cuda":
        return _back_half_cuda(audio, wet, scal, layout, rate, eq)
    if wet.device.type != "cpu":
        raise ValueError(f"back_half runs on cuda or cpu tensors, not {wet.device}")
    return back_half_plain(audio, wet, scal, layout, rate, eq)
