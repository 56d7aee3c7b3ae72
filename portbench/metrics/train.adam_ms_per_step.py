"""Device ms a step of Adam's foreach (capturable) kernels."""

from portbench import layer

LAYER = "optimizer"
UNIT = "ms"
BETTER = "lower"
MOVES = "train_audio_s_per_s"


def read(ctx):
    return layer.group_ms_per_unit(ctx, "adam")
