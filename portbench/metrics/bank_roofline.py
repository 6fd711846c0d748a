"""The IR bank's share of its bytes roofline, read from the traced window:
the device time of ``fused_rir_bank``'s two kernels (``bank_stats_kernel``,
``bank_write_kernel``) per call, over every call the window's batches made.
Its contract reads a seed and four scalars per clip and writes the (early,
late) float32 IR pair; the noise is hashed, never read."""

from portbench.reference import render as ref
from portbench.roofline import share_pct

KERNELS = ("bank_stats_kernel", "bank_write_kernel")


def read(run):
    summary, c = run.trace_summary, run.cell
    if not summary or not c:
        return None
    seconds, calls = 0.0, 0
    for name, (t, launches) in summary["by_name"].items():
        if any(k in name for k in KERNELS):
            seconds += t
            if KERNELS[1] in name:
                calls += launches
    if not calls:
        return None
    batch = c["batch"]
    length = ref.derive(c["params"], c["rate"])["length"]
    nbytes = 2 * batch * length * 4 + batch * 4 + batch * 4 * 4
    return share_pct(nbytes, seconds / calls, run.device)
