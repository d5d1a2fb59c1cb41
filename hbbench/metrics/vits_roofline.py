"""VITS ``infer``: the least time of the traced calls (the larger of their
operations at 67 TFLOP/s float32 and their bytes at 3.35 TB/s, counted by
``vits_work`` from each clip's own ids and the frames it uses, not the
padded budget) over their device time (``vits_infer_ms.vits``'s kernels and
copies), in percent."""

from hbbench import vits_work, work
from hbbench.traffic import vitsgen


def read(ctx):
    totals = vitsgen.infer_totals(ctx)
    calls = ctx.extra.get("state", {}).get("traced_calls")
    if totals is None or not calls or totals[0] != len(calls) or not totals[2]:
        return None
    cfg = ctx.config["vits"]
    least = sum(work.least_seconds(*vits_work.infer_work(ids, frames, cfg), work.PEAK_FP32) for ids, frames in calls)
    return 100.0 * least / totals[2]
