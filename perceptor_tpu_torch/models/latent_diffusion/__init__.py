"""CompVis latent-diffusion family (counterpart of
perceptor_tpu/models/latent_diffusion/)."""

from perceptor_tpu_torch.models.latent_diffusion.text2image import Text2Image
from perceptor_tpu_torch.models.latent_diffusion.face import Face
from perceptor_tpu_torch.models.latent_diffusion.super_resolution import SuperResolution
from perceptor_tpu_torch.models.latent_diffusion.first_stage import (
    VQModel,
    VectorQuantizer,
    convert_compvis_autoencoder,
)
from perceptor_tpu_torch.models.latent_diffusion.bert import BERTEncoder, BERTTokenizer

__all__ = [
    "Text2Image",
    "Face",
    "SuperResolution",
    "VQModel",
    "VectorQuantizer",
    "convert_compvis_autoencoder",
    "BERTEncoder",
    "BERTTokenizer",
]
