"""Device ms a step of NCCL's kernels on rank 0, waiting for the other
ranks included."""

from portbench import layer

LAYER = "data parallel"
UNIT = "ms"
BETTER = "lower"
MOVES = "train_audio_s_per_s"


def read(ctx):
    return layer.group_ms_per_unit(ctx, "collective")
