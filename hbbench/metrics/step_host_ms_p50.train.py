"""Median host milliseconds of the program's ``trainer/step`` range: the
eager step's forward, backward and Adam as the host dispatches them."""

from hbbench import program_spans


def read(ctx):
    step = program_spans.spans(ctx, "trainer/step")
    return None if step is None else program_spans.median_ms(step["host_s"])
