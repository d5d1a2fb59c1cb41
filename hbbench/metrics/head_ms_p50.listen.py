"""Median host milliseconds of the program's ``wakeword/head`` range per
scored chunk: the contexts' upload, the head's forward and the copy back."""

from hbbench import program_spans


def read(ctx):
    head = program_spans.spans(ctx, "wakeword/head")
    return None if head is None else program_spans.median_ms(head["host_s"])
