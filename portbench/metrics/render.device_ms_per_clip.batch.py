"""Device milliseconds per clip: the time in the traced window in which a
kernel ran on the card (the union over both streams, copies left out), over
the clips completed in it."""


def read(run):
    summary = run.trace_summary
    clips = run.counters.get("clips_done")
    if not summary or not clips or summary["kernel_s"] <= 0:
        return None
    return 1000.0 * summary["kernel_s"] / clips
