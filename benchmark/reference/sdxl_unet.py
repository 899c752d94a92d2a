"""Plain Stable Diffusion XL UNet (diffusers `UNet2DConditionModel` with
`transformer_layers_per_block`, `use_linear_projection` and
`addition_embed_type: text_time`), under diffusers' state_dict names, in
float32. The resnets, transformer blocks, attention, resamplers and time
embedding are `sd_unet.py`'s.

Configuration keys are those of the model's `unet/config.json`:
`in_channels`, `out_channels`, `block_out_channels`, `layers_per_block`,
`down_block_types`, `transformer_layers_per_block` (one a level; the mid
block takes the last, the up blocks the reversed list),
`attention_head_dim` (the number of heads, one a level), `cross_attention_dim`,
`use_linear_projection`, `norm_num_groups`, `norm_eps`, `flip_sin_to_cos`,
`freq_shift`, `addition_time_embed_dim` and
`projection_class_embeddings_input_dim`. The added embedding: each of the
six size ids a sinusoid of `addition_time_embed_dim`, joined after the
pooled text embedding, through `add_embedding` (a `TimestepEmbedding`),
added to the timestep embedding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import Conv2d, Linear, group_norm
from benchmark.reference.sd_unet import (
    BasicTransformerBlock, Block, Downsample2D, ResnetBlock2D, TimestepEmbedding, Upsample2D,
    timestep_embedding,
)


def _per_level(value, levels: int) -> list:
    return list(value) if isinstance(value, (list, tuple)) else [value] * levels


class Transformer2DModel(nn.Module):
    """GroupNorm, `proj_in`, `depth` transformer blocks over the H x W
    tokens, `proj_out`, plus the input; the projections linears over the
    tokens with `linear`, else 1 x 1 convolutions."""

    def __init__(self, channels, heads, context_dim, groups, depth, linear):
        super().__init__()
        self.linear = linear
        self.norm = group_norm(channels, 1e-6, groups)
        proj = Linear if linear else (lambda a, b: Conv2d(a, b, 1))
        self.proj_in = proj(channels, channels)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, heads, context_dim) for _ in range(depth)])
        self.proj_out = proj(channels, channels)

    def forward(self, x, context):
        b, c, h, w = x.shape
        y = self.norm(x)
        if self.linear:
            y = self.proj_in(y.permute(0, 2, 3, 1).reshape(b, h * w, c))
        else:
            y = self.proj_in(y).permute(0, 2, 3, 1).reshape(b, h * w, c)
        for block in self.transformer_blocks:
            y = block(y, context)
        if self.linear:
            return self.proj_out(y).reshape(b, h, w, c).permute(0, 3, 1, 2) + x
        return self.proj_out(y.reshape(b, h, w, c).permute(0, 3, 1, 2)) + x


class SDXLUNet(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        ch = cfg["block_out_channels"]
        n = len(ch)
        heads = _per_level(cfg["attention_head_dim"], n)
        depth = _per_level(cfg["transformer_layers_per_block"], n)
        ctx, linear = cfg["cross_attention_dim"], cfg["use_linear_projection"]
        groups, eps = cfg["norm_num_groups"], cfg["norm_eps"]
        cross = [t.startswith("CrossAttn") for t in cfg["down_block_types"]]
        temb = 4 * ch[0]
        layers = cfg["layers_per_block"]
        self.conv_in = Conv2d(cfg["in_channels"], ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], temb)
        self.add_embedding = TimestepEmbedding(cfg["projection_class_embeddings_input_dim"], temb)

        def resnet(cin, cout):
            return ResnetBlock2D(cin, cout, temb, groups, eps)

        def transformers(level, count):
            return [Transformer2DModel(ch[level], heads[level], ctx, groups, depth[level], linear)
                    for _ in range(count)] if cross[level] else None

        down, skips, cin = [], [ch[0]], ch[0]
        for i, c in enumerate(ch):
            resnets = [resnet(cin if j == 0 else c, c) for j in range(layers)]
            skips += [c] * layers
            last = i == n - 1
            if not last:
                skips.append(c)
            down.append(Block(resnets, transformers(i, layers),
                              None if last else Downsample2D(c), "downsamplers"))
            cin = c
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = Block(
            [resnet(ch[-1], ch[-1]), resnet(ch[-1], ch[-1])],
            [Transformer2DModel(ch[-1], heads[-1], ctx, groups, depth[-1], linear)])
        up, cin = [], ch[-1]
        for i, c in enumerate(reversed(ch)):
            level = n - 1 - i
            resnets = []
            for _ in range(layers + 1):
                resnets.append(resnet(cin + skips.pop(), c))
                cin = c
            up.append(Block(resnets, transformers(level, layers + 1),
                            Upsample2D(c) if level > 0 else None, "upsamplers"))
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = group_norm(ch[0], eps, groups)
        self.conv_out = Conv2d(ch[0], cfg["out_channels"], 3, padding=1)

    def forward(self, x, t, context, text_embeds, time_ids):
        """Noise prediction for latents `x` (N, C, h, w) at timesteps `t`
        (N,) under `context` (N, S, cross_attention_dim), the pooled
        `text_embeds` (N, P) and the size ids `time_ids` (N, 6)."""
        cfg = self.cfg
        flip, shift = cfg["flip_sin_to_cos"], cfg["freq_shift"]
        temb = self.time_embedding(timestep_embedding(t, cfg["block_out_channels"][0], flip,
                                                      shift))
        ids = timestep_embedding(time_ids.reshape(-1), cfg["addition_time_embed_dim"], flip,
                                 shift).reshape(x.shape[0], -1)
        temb = temb + self.add_embedding(torch.cat([text_embeds, ids], dim=-1))
        x = self.conv_in(x)
        skips = [x]
        for block in self.down_blocks:
            for j, res in enumerate(block.resnets):
                x = res(x, temb)
                if hasattr(block, "attentions"):
                    x = block.attentions[j](x, context)
                skips.append(x)
            if hasattr(block, "downsamplers"):
                x = block.downsamplers[0](x)
                skips.append(x)
        x = self.mid_block.resnets[0](x, temb)
        x = self.mid_block.attentions[0](x, context)
        x = self.mid_block.resnets[1](x, temb)
        for block in self.up_blocks:
            for j, res in enumerate(block.resnets):
                x = res(torch.cat([x, skips.pop()], dim=1), temb)
                if hasattr(block, "attentions"):
                    x = block.attentions[j](x, context)
            if hasattr(block, "upsamplers"):
                x = block.upsamplers[0](x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))
