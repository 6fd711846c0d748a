"""Share of the traced window in which nothing ran on the card."""


def read(run):
    """100 × (1 − busy / window): the window's share with no kernel or copy
    on the card; None when the trace saw no device work."""
    summary = run.trace_summary
    if not summary or summary["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
