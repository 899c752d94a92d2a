from perceptor_tpu_torch.predictions import diffusion_space
from perceptor_tpu_torch.predictions.edm import EDMPredictions
from perceptor_tpu_torch.predictions.indexed import (
    IndexedEpsPredictions,
    LatentIndexedEpsPredictions,
)
from perceptor_tpu_torch.predictions.velocity import VelocityPredictions

__all__ = [
    "diffusion_space", "EDMPredictions", "IndexedEpsPredictions", "LatentIndexedEpsPredictions",
    "VelocityPredictions",
]
