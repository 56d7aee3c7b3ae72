"""The median over the slice's utterances of the host seconds of one
``decode_mel`` call and its waveform's D2H."""

from portbench import layer

LAYER = "vocoder"
UNIT = "ms"
BETTER = "lower"
MOVES = "convert_p95_ms"


def read(ctx):
    return layer.span_p50_ms(ctx, "vocoder")
