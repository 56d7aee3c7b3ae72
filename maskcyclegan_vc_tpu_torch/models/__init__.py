from maskcyclegan_vc_tpu_torch.models.generator import Generator, ResidualBlock

__all__ = ["Generator", "ResidualBlock"]
