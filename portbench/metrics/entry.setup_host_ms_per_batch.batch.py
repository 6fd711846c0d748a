"""Host milliseconds per ``render_batch`` call before anything is enqueued
(the program's ``ars.setup`` span): each clip's host-derived setup, the
checks, the seeds and the host side of the scalar tables."""

from portbench import program_spans


def read(run):
    return program_spans.host_ms_per_call("ars.setup")
