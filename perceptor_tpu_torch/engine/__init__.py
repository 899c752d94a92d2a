from perceptor_tpu_torch.engine.guidance import (
    export_guided_sample,
    guided_noise_shape,
    guided_sample,
    make_guidance_step,
    optimize,
    run_on_device,
)

__all__ = ["export_guided_sample", "guided_noise_shape", "guided_sample", "make_guidance_step",
           "optimize", "run_on_device"]
