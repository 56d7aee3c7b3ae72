"""The share of the traced slice in which no operation ran on the device."""

from portbench import layer

LAYER = "device"
UNIT = "%"
BETTER = "lower"
MOVES = "train_audio_s_per_s"


def read(ctx):
    return layer.idle_pct(ctx)
