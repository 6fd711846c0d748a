"""Stream milliseconds per clip of the shelf EQ inside the back half (the
program's ``ars.eq`` span: the length-dynamic EQ of a padded batch), over the
window's calls; shares the card with the other batch in flight
(``portbench.program_spans``)."""

from portbench import program_spans


def read(run):
    return program_spans.stream_ms_per_clip(run, "ars.eq")
