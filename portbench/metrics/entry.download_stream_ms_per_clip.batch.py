"""Stream milliseconds per clip of the way down (the program's ``ars.download``
span: PCM16 quantization, the transpose, the metric table and the copy into
page-locked memory), over the window's calls; shares the card with the
other batch in flight (``portbench.program_spans``)."""

from portbench import program_spans


def read(run):
    return program_spans.stream_ms_per_clip(run, "ars.download")
