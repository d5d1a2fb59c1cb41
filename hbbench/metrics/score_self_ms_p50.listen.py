"""Median host milliseconds per scored chunk of ``listen/score``'s own time
plus its ``wakeword/prepare`` and ``wakeword/contexts`` children: the
chunk's host glue outside the featurizer and the head."""

import statistics

from hbbench import program_spans


def read(ctx):
    score = program_spans.spans(ctx, "listen/score")
    prepare = program_spans.spans(ctx, "wakeword/prepare")
    contexts = program_spans.spans(ctx, "wakeword/contexts")
    if score is None or prepare is None or contexts is None:
        return None
    parts = (score["self_s"], prepare["host_s"], contexts["host_s"])
    if len({len(p) for p in parts}) != 1:
        return None  # not one of each per chunk
    return 1e3 * statistics.median(sum(chunk) for chunk in zip(*parts))
