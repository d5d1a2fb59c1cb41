"""Device operations (kernels and copies) in the trace per trainer step
traced, the evaluations among them included."""


def read(ctx):
    trace, steps = ctx.recorder.trace, ctx.results.get("traced_steps")
    if not trace or not steps or not trace["kernels"]:
        return None
    return len(trace["kernels"]) / steps
