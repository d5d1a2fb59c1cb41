"""Device milliseconds of one ``Vits.infer`` call: the time of the kernels and
copies that the trace puts down to the program's ``vits/infer`` range and its
stage ranges, over the traced calls."""

from hbbench.traffic import vitsgen


def read(ctx):
    totals = vitsgen.infer_totals(ctx)
    if totals is None:
        return None
    calls, _, device_s = totals
    return 1e3 * device_s / calls
