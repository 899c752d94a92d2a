from perceptor_tpu_torch.models.monster_diffusion.monster_diffusion import MonsterDiffusion
from perceptor_tpu_torch.models.monster_diffusion.net import MonsterConfig, MonsterUNet

__all__ = ["MonsterConfig", "MonsterDiffusion", "MonsterUNet"]
