"""Median host milliseconds a VITS batch spends outside ``infer``: its
``vits/inputs`` (ids, speaker slerp, budget, upload), ``vits/download``
(the audio's copy back, waiting for the call's kernels) and ``tts/resample``
(resampling to 16 kHz, int16, trimming) ranges, summed batch by batch."""

import statistics

from hbbench import program_spans

PARTS = ("vits/inputs", "vits/download", "tts/resample")


def read(ctx):
    found = [program_spans.spans(ctx, name) for name in PARTS]
    if any(f is None for f in found) or len({len(f["host_s"]) for f in found}) != 1:
        return None
    return 1e3 * statistics.median(sum(parts) for parts in zip(*(f["host_s"] for f in found)))
