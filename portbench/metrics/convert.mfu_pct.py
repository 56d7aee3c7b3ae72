"""The reference's operations for the slice's conversions and decodes, each
at its utterance's own length, over the slice's wall time, as a share of
the f32 peak (67 TFLOP/s)."""

from portbench import layer

LAYER = "conversion and decode"
UNIT = "%"
BETTER = "higher"
MOVES = "convert_audio_s_per_s"


def read(ctx):
    return layer.mfu_pct(ctx)
