"""Device ms a step of every operation that is not a convolution, one of
the port's kernels, Adam or a collective: the eager InstanceNorm
backwards, the bf16 casts, the losses, copies and sets."""

from portbench import layer

LAYER = "eager ops"
UNIT = "ms"
BETTER = "lower"
MOVES = "train_audio_s_per_s"


def read(ctx):
    return layer.group_ms_per_unit(ctx, "eager")
