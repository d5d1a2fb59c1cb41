"""Device milliseconds of a fused batch's noise draws and render (CUDA
events from before ``clip_noise`` to after ``render``), the mean over the
traced batches."""


def read(ctx):
    events = ctx.recorder.values.get("render_events")
    if not events:
        return None
    return sum(start.elapsed_time(end) for start, end in events) / len(events)
