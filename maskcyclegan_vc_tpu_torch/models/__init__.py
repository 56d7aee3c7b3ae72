from maskcyclegan_vc_tpu_torch.models.discriminator import Discriminator
from maskcyclegan_vc_tpu_torch.models.generator import Generator, ResidualBlock

__all__ = ["Discriminator", "Generator", "ResidualBlock"]
