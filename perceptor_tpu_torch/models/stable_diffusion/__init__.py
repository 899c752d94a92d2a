from perceptor_tpu_torch.models.stable_diffusion.stable_diffusion import (
    Conditioning,
    StableDiffusion,
)
from perceptor_tpu_torch.models.stable_diffusion.text_encoder import CLIPTextEncoder
from perceptor_tpu_torch.models.stable_diffusion.unet import UNet
from perceptor_tpu_torch.models.stable_diffusion.vae import AutoencoderKL

__all__ = ["AutoencoderKL", "CLIPTextEncoder", "Conditioning", "StableDiffusion", "UNet"]
