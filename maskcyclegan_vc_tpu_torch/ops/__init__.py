"""Layers and the hand-written CUDA kernels with their plain versions."""

from maskcyclegan_vc_tpu_torch.ops.in_gate import (
    instance_norm,
    instance_norm_glu,
    instance_norm_glu_plain,
    instance_norm_plain,
)
from maskcyclegan_vc_tpu_torch.ops.layers import GatedConv2d, InstanceNorm, swish
from maskcyclegan_vc_tpu_torch.ops.ps import (
    pixel_shuffle_in_swish,
    pixel_shuffle_in_swish_plain,
)

__all__ = [
    "GatedConv2d", "InstanceNorm", "instance_norm", "instance_norm_glu",
    "instance_norm_glu_plain", "instance_norm_plain", "pixel_shuffle_in_swish",
    "pixel_shuffle_in_swish_plain", "swish",
]
