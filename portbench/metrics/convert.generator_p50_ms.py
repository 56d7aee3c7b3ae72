"""The median over the slice's utterances of the host seconds of one
``make_convert_fn`` call: H2D, the generator, D2H."""

from portbench import layer

LAYER = "conversion"
UNIT = "ms"
BETTER = "lower"
MOVES = "convert_p95_ms"


def read(ctx):
    return layer.span_p50_ms(ctx, "generator")
