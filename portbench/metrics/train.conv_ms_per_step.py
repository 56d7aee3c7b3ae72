"""Device ms a step of cuDNN's and cuBLAS's convolution and GEMM kernels
(``names.CONV_KERNELS``)."""

from portbench import layer

LAYER = "convolutions"
UNIT = "ms"
BETTER = "lower"
MOVES = "train_audio_s_per_s"


def read(ctx):
    return layer.group_ms_per_unit(ctx, "conv")
