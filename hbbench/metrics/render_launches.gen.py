"""Device operations (kernels and copies) put down to the program's
``formant/render`` range, per range: the launches of one batch's render."""

from hbbench import program_spans


def read(ctx):
    render = program_spans.spans(ctx, "formant/render")
    return None if render is None else render["launches"] / len(render["host_s"])
