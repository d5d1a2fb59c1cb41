"""Trainer steps completed over the window's seconds, the evaluations every
``validation_steps`` steps included (host clock). With ``--trace 1`` its first
part runs under the profiler."""


def read(ctx):
    return ctx.results.get("steps_per_s")
