"""The share of the traced window in which no kernel or copy ran on the device, in percent."""

from hbbench import tracing


def read(ctx):
    return tracing.idle_percent(ctx.recorder.trace)
