"""K1 (``mel_patches``): its least time on the traced batches (the larger of
its operations at 67 TFLOP/s float32 and its bytes at 3.35 TB/s) over its
device time in the trace, in percent."""

from hbbench import tracing, work


def read(ctx):
    sizes = ctx.extra.get("state", {}).get("traced_sizes")
    seconds, launches = tracing.kernel_seconds(ctx.recorder.trace, "mel_patches_kernel")
    if not sizes or not launches or launches != len(sizes):
        return None
    t = ctx.config["clip_samples"]
    least = sum(work.least_seconds(*work.k1_work(b, t), work.PEAK_FP32) for b in sizes)
    return 100.0 * least / seconds
