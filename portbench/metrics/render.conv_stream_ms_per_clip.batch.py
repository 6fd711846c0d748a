"""Stream milliseconds per clip of the convolution (the program's ``ars.conv``
span: the FFT convolution with both IRs, the fast air's gain included),
over the window's calls; shares the card with the other batch in flight
(``portbench.program_spans``)."""

from portbench import program_spans


def read(run):
    return program_spans.stream_ms_per_clip(run, "ars.conv")
