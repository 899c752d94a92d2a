from perceptor_tpu_torch.engine.guidance import (
    draw_guided_noise,
    export_guided_sample,
    guided_noise_shape,
    guided_sample,
    make_guidance_step,
    optimize,
    run_on_device,
)

__all__ = ["draw_guided_noise", "export_guided_sample", "guided_noise_shape", "guided_sample", "make_guidance_step",
           "optimize", "run_on_device"]
