from perceptor_tpu_torch.predictions.indexed import LatentIndexedEpsPredictions

__all__ = ["LatentIndexedEpsPredictions"]
