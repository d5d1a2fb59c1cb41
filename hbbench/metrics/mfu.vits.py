"""The cache fill's share of the chip's peak over the whole window: the
window's VITS calls' operations (``vits_work``, from each clip's own ids and
the frames it uses) at 67 TFLOP/s float32, plus each written clip's mel (67
TFLOP/s) and embedding (989 TFLOP/s bf16) operations, over the window's
seconds, in percent."""

from hbbench import vits_work, work


def read(ctx):
    clips, window = ctx.results.get("clips"), ctx.results.get("window_s")
    calls = ctx.extra.get("state", {}).get("work")
    if not clips or not window or not calls:
        return None
    cfg, t, e = ctx.config["vits"], ctx.config["clip_samples"], ctx.config["embedding"]
    vits = sum(vits_work.infer_work(ids, frames, cfg)[0] for ids, frames in calls) / work.PEAK_FP32
    per_clip = work.k1_work(1, t)[0] / work.PEAK_FP32 + work.k2_work(1, t, e)[0] / work.PEAK_BF16
    return 100.0 * (vits + clips * per_clip) / window
