"""Host milliseconds per ``render_batch`` call after its set-up: the
program's ``ars.render_batch`` span less its ``ars.setup``, i.e. the host
enqueueing the copies and kernels (and any host wait among them)."""

from portbench import program_spans


def read(run):
    return program_spans.host_ms_per_call("ars.render_batch", less="ars.setup")
