"""The featurize step's share of the chip's peak over the whole window: the
clips written times the least time of one clip's mel (its operations at 67
TFLOP/s float32) and embedding (its operations at 989 TFLOP/s bf16), over
the window's seconds, in percent."""

from hbbench import work


def read(ctx):
    clips, window = ctx.results.get("clips"), ctx.results.get("window_s")
    if not clips or not window:
        return None
    t, e = ctx.config["clip_samples"], ctx.config["embedding"]
    per_clip = work.k1_work(1, t)[0] / work.PEAK_FP32 + work.k2_work(1, t, e)[0] / work.PEAK_BF16
    return 100.0 * clips * per_clip / window
