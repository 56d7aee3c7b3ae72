"""ms an utterance that the device waited on the host inside the program's
``decode`` spans of the slice (``models/melgan.decode_mel``: the mel, mean
and std to the device, the vocoder's launches), from ``portbench/spans.py``."""

from portbench import spans

LAYER = "vocoder"
UNIT = "ms"
BETTER = "lower"
MOVES = "convert_p95_ms"


def read(ctx):
    return spans.within_ms_per_unit(ctx, "convert", "decode")
