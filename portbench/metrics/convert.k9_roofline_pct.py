"""K9's least time over the slice's decodes (``bounds.decode_bound_s``:
operations at the 3xTF32 rate in f32) over its device time."""

from portbench import layer

LAYER = "K9 kernel"
UNIT = "%"
BETTER = "higher"
MOVES = "convert_audio_s_per_s"


def read(ctx):
    return layer.roofline_pct(ctx, ("melgan_stack",))
