from perceptor_tpu_torch.engine.guidance import guided_sample

__all__ = ["guided_sample"]
