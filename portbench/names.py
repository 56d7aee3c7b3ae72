"""Device kernels by name: the port's kernels and the groups of the rest.

Copied at commit 05371c2 from ``maskcyclegan_vc_tpu_torch/obs/profiler.py``
(``KERNEL_NAMES``) and from ``chip_smoke.py`` (``CONV_KERNELS``, the Adam
pattern of ``profile``, ``COLLECTIVE_KERNELS``), so that a later change to
the program cannot move the yardstick.
"""

from __future__ import annotations

import re

# The port's kernels by their names in a trace's kernel events. K1, K2 and
# K3 are one template, in_staged_kernel<T, Epilogue, ...>, told apart by
# its epilogue (kGlu 2, kNone 0, kSwish 1).
KERNEL_NAMES = {
    "in_glu": r"in_staged_kernel<\w+,[^,]*(?:2|kGlu)\s*,",
    "in": r"in_staged_kernel<\w+,[^,]*(?:0|kNone)\s*,",
    "in_swish": r"in_staged_kernel<\w+,[^,]*(?:1|kSwish)\s*,",
    "ps_in_swish": r"ps_in_swish_kernel",
    "ps_in_swish_bwd": r"ps_in_swish_backward_kernel",
    "shuffle": r"(?<!inverse_)pixel_shuffle_kernel",
    "inv_shuffle": r"inverse_pixel_shuffle_kernel",
    "log_mel": r"log_mel_kernel",
    "melgan_stack": r"resblock_(?:tc|bf16)_kernel|tail_kernel",
}
PORT_KERNELS = "|".join(KERNEL_NAMES.values())
# cuDNN's and cuBLAS's convolution and GEMM kernels.
CONV_KERNELS = r"conv|xmma|gemm|cudnn|wgrad|dgrad|fprop|winograd|implicit"
# torch.optim.Adam's foreach (capturable) update.
ADAM_KERNELS = r"multi_tensor_apply|foreach"
# NCCL's kernels, and its one-rank reduction.
COLLECTIVE_KERNELS = r"nccl|onerank"

GROUPS = (("kernels", PORT_KERNELS), ("conv", CONV_KERNELS), ("adam", ADAM_KERNELS),
          ("collective", COLLECTIVE_KERNELS))


def group(name: str) -> str:
    """The group of a device event's name, the first that matches: the
    port's kernels, convolutions, Adam, collectives, else "eager" (the
    eager ops, copies and sets)."""
    return next((g for g, pat in GROUPS if re.search(pat, name)), "eager")
