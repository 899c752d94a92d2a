from perceptor_tpu_torch.models.guided_diffusion import config
from perceptor_tpu_torch.models.guided_diffusion.guided_diffusion import GuidedDiffusion
from perceptor_tpu_torch.models.guided_diffusion.unet import ADMUNet

__all__ = ["GuidedDiffusion", "ADMUNet", "config"]
