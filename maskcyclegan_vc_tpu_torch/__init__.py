"""MaskCycleGAN-VC in PyTorch for an NVIDIA GPU (H100, sm_90a).

A port of the JAX package ``maskcyclegan_vc_tpu``, which stays the
reference it is tested against. It imports neither JAX nor that package.
"""

from maskcyclegan_vc_tpu_torch.models import Generator

__all__ = ["Generator"]
