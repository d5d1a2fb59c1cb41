"""Mean host milliseconds of the program's ``features/drain/copy`` range: the
drain's copy of a fused batch to the host, which waits until the batch's
kernels (and those queued before them) have run."""

import statistics

from hbbench import program_spans


def read(ctx):
    copy = program_spans.spans(ctx, "features/drain/copy")
    return None if copy is None else 1e3 * statistics.fmean(copy["host_s"])
