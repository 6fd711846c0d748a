"""Stream milliseconds per clip of the copy up (the program's ``ars.upload``
span: the page-locked clips to the card, the transpose and the mono
duplication), over the window's calls; shares the card with the other
batch in flight (``portbench.program_spans``)."""

from portbench import program_spans


def read(run):
    return program_spans.stream_ms_per_clip(run, "ars.upload")
