from perceptor_tpu_torch.schedules.ddpm import scaled_linear_alphas_sigmas

__all__ = ["scaled_linear_alphas_sigmas"]
