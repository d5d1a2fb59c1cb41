"""The median host milliseconds of ``SpeechEmbeddings.__call__`` per scored
chunk of the window (the buffer's scaling, upload, K1, K2 and the copy back)."""

import statistics


def read(ctx):
    spans = ctx.recorder.spans.get("embed")
    if not spans:
        return None
    return 1e3 * statistics.median(spans)
