"""The head's share of the chip's float32 peak (67 TFLOP/s, TF32 off) over
the whole window: each step's rows through the head's forward and backward
(three times the forward's multiply-adds) and each evaluation's rows through
its forward, over the window's seconds, in percent."""

from hbbench import work


def read(ctx):
    r = ctx.results
    if not r.get("steps") or not r.get("window_s"):
        return None
    head = ctx.config["head"]
    row = work.transformer_row_flops(head) if head["architecture"] == "transformer" \
        else work.perceptron_row_flops(head)
    flops = r["steps"] * r["rows_per_step"] * 3 * row + r["evals"] * r["eval_rows"] * row
    return 100.0 * flops / (work.PEAK_FP32 * r["window_s"])
