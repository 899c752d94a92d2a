from perceptor_tpu_torch.models.stable_diffusion.unet import UNet
from perceptor_tpu_torch.models.stable_diffusion.vae import AutoencoderKL

__all__ = ["AutoencoderKL", "UNet"]
