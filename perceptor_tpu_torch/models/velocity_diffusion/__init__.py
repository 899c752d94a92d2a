from perceptor_tpu_torch.models.velocity_diffusion import configs
from perceptor_tpu_torch.models.velocity_diffusion.net import VDiffusionUNet
from perceptor_tpu_torch.models.velocity_diffusion.velocity_diffusion import VelocityDiffusion

__all__ = ["VelocityDiffusion", "VDiffusionUNet", "configs"]
