"""ms an utterance that the device waited on the host inside the program's
``convert`` spans of the slice (``cli/test.make_convert_fn``: staging and
H2D, the generator's launches, D2H), from ``portbench/spans.py``."""

from portbench import spans

LAYER = "conversion"
UNIT = "ms"
BETTER = "lower"
MOVES = "convert_p95_ms"


def read(ctx):
    return spans.within_ms_per_unit(ctx, "convert", "convert")
