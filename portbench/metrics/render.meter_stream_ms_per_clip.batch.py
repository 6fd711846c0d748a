"""Stream milliseconds per clip of the meter (the program's ``ars.meter`` span:
LUFS, sample peak and RMS, masked to the true lengths in a padded batch),
over the window's calls; shares the card with the other batch in flight
(``portbench.program_spans``)."""

from portbench import program_spans


def read(run):
    return program_spans.stream_ms_per_clip(run, "ars.meter")
