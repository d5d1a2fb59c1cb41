"""Device operations (kernels and copies) put down to the program's
``vits/infer`` range and the stage ranges inside it, per ``infer`` call."""

from hbbench.traffic import vitsgen


def read(ctx):
    totals = vitsgen.infer_totals(ctx)
    if totals is None:
        return None
    calls, launches, _ = totals
    return launches / calls
