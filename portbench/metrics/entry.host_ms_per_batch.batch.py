"""Host milliseconds of one enqueueing ``render_batch(async_results=True)``
call, from the harness's span around it, over the window."""


def read(run):
    spans = run.spans.get("render_batch")
    if not spans:
        return None
    return 1000.0 * sum(spans) / len(spans)
