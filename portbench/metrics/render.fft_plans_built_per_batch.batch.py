"""cuFFT plans built per ``render_batch`` call in the window: the program's
counter ``ars.fft_plans_built`` (the growth of the card's plan cache over each
call) over its ``ars.render_batch`` calls.  Steady state reads 0: a padded
batch's length-dynamic EQ keeps one plan set per bucket."""

from portbench import program_spans


def read(run):
    return program_spans.count_per_call("ars.fft_plans_built", "ars.render_batch")
