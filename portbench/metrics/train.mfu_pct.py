"""The reference's operations for the slice's steps (forward and backward,
counted on meta tensors) over its wall time, as a share of the dtype's
dense peak: 989 TFLOP/s bf16, 67 TFLOP/s f32."""

from portbench import layer

LAYER = "train step"
UNIT = "%"
BETTER = "higher"
MOVES = "train_audio_s_per_s"


def read(ctx):
    return layer.mfu_pct(ctx)
