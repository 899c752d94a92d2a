from perceptor_tpu_torch.engine.guidance import (
    guided_sample,
    make_guidance_step,
    optimize,
    run_on_device,
)

__all__ = ["guided_sample", "make_guidance_step", "optimize", "run_on_device"]
