from perceptor_tpu_torch.predictions.edm import EDMPredictions
from perceptor_tpu_torch.predictions.indexed import (
    IndexedEpsPredictions,
    LatentIndexedEpsPredictions,
)
from perceptor_tpu_torch.predictions.velocity import VelocityPredictions

__all__ = [
    "EDMPredictions", "IndexedEpsPredictions", "LatentIndexedEpsPredictions",
    "VelocityPredictions",
]
