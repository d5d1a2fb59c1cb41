"""K2 (``embedding_pool``: its trunk and pooling kernels): its least time on
the traced batches (the larger of its operations at 989 TFLOP/s bf16 and its
bytes at 3.35 TB/s) over their device time in the trace, in percent."""

from hbbench import tracing, work


def read(ctx):
    sizes = ctx.extra.get("state", {}).get("traced_sizes")
    trunk, launches = tracing.kernel_seconds(ctx.recorder.trace, "embedding_trunk_kernel")
    pool, _ = tracing.kernel_seconds(ctx.recorder.trace, "embedding_pool_kernel")
    if not sizes or not launches or launches != len(sizes):
        return None
    t, e = ctx.config["clip_samples"], ctx.config["embedding"]
    least = sum(work.least_seconds(*work.k2_work(b, t, e), work.PEAK_BF16) for b in sizes)
    return 100.0 * least / (trunk + pool)
