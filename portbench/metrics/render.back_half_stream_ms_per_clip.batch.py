"""Stream milliseconds per clip of the back half less its EQ (the program's
``ars.back_half`` span less ``ars.eq``: the dry pad, mix, the three
normalizations, pan and layout map), over the window's calls; shares the
card with the other batch in flight (``portbench.program_spans``)."""

from portbench import program_spans


def read(run):
    return program_spans.stream_ms_per_clip(run, "ars.back_half", self_time=True)
