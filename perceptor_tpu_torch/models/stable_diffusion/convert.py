"""CompVis (original `.ckpt`) UNet names -> the port's diffusers names (a copy
of `compvis_to_diffusers_unet` in perceptor_tpu/models/stable_diffusion/
convert.py; the port imports nothing of the JAX package).

The CompVis/LDM `openaimodel.py` layout (`input_blocks.{i}.{m}`,
`middle_block.{m}`, `output_blocks.{i}.{m}`) and diffusers'
UNet2DConditionModel hold the same tensors under other names; the spatial
transformers' inner names (`transformer_blocks.{k}.attn1.to_q`, ...) agree.
The map only renames: every value is passed through as it is.
"""

from __future__ import annotations

from typing import Dict

from perceptor_tpu_torch.models.stable_diffusion.config import UNetConfig

_COMPVIS_RES = {
    "in_layers.0": "norm1",
    "in_layers.2": "conv1",
    "emb_layers.1": "time_emb_proj",
    "out_layers.0": "norm2",
    "out_layers.3": "conv2",
    "skip_connection": "conv_shortcut",
}


def compvis_to_diffusers_unet(
    state_dict: Dict, cfg: UNetConfig, prefix: str = "model.diffusion_model."
) -> Dict:
    """A CompVis UNet state_dict (keys under `prefix`, or bare keys when
    none carries it) -> a state_dict for the port's `UNet`."""
    sd = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
    if not sd:
        sd = dict(state_dict)
    out: Dict = {}

    def move(src, dst):
        for suffix in ("weight", "bias"):
            if f"{src}.{suffix}" in sd:
                out[f"{dst}.{suffix}"] = sd[f"{src}.{suffix}"]

    def move_tree(src, dst):
        n = len(src) + 1
        for k, v in sd.items():
            if k.startswith(src + "."):
                out[dst + "." + k[n:]] = v

    def move_res(src, dst):
        for old, new in _COMPVIS_RES.items():
            move(f"{src}.{old}", f"{dst}.{new}")

    move("time_embed.0", "time_embedding.linear_1")
    move("time_embed.2", "time_embedding.linear_2")
    move("input_blocks.0.0", "conv_in")
    move("out.0", "conv_norm_out")
    move("out.2", "conv_out")
    move_res("middle_block.0", "mid_block.resnets.0")
    move_res("middle_block.2", "mid_block.resnets.1")
    move_tree("middle_block.1", "mid_block.attentions.0")

    n_levels = len(cfg.channel_mults)
    r = cfg.n_res_blocks
    for b in range(n_levels):
        for j in range(r):
            i = 1 + b * (r + 1) + j
            move_res(f"input_blocks.{i}.0", f"down_blocks.{b}.resnets.{j}")
            if cfg.cross_attention[b]:
                move_tree(f"input_blocks.{i}.1", f"down_blocks.{b}.attentions.{j}")
        if b < n_levels - 1:
            i = (b + 1) * (r + 1)
            move(f"input_blocks.{i}.0.op", f"down_blocks.{b}.downsamplers.0.conv")
    for b in range(n_levels):
        level = n_levels - 1 - b
        for j in range(r + 1):
            i = b * (r + 1) + j
            move_res(f"output_blocks.{i}.0", f"up_blocks.{b}.resnets.{j}")
            has_attn = cfg.cross_attention[level]
            if has_attn:
                move_tree(f"output_blocks.{i}.1", f"up_blocks.{b}.attentions.{j}")
            if level > 0 and j == r:
                up_idx = 2 if has_attn else 1
                move(f"output_blocks.{i}.{up_idx}.conv", f"up_blocks.{b}.upsamplers.0.conv")
    return out
