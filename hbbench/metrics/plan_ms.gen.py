"""Host milliseconds of planning (``DeviceFormantTTS.plan_batch``) per fused
batch of the window."""


def read(ctx):
    batches = ctx.extra.get("state", {}).get("batches", 0)
    plans = ctx.recorder.spans.get("plan")
    if not batches or not plans:
        return None
    return 1e3 * sum(plans) / batches
