"""CLIP with a ViT or ModifiedResNet image tower and the text tower
(counterpart of perceptor_tpu/models/clip/model.py `VisionTransformer`,
`TextTransformer` and `CLIP`; the ResNet is `models/clip/resnet.py`).

Module names follow open_clip (`visual.conv1`, `visual.class_embedding`,
`visual.transformer.resblocks.{i}.attn.in_proj_weight`, ...,
`token_embedding.weight`, `positional_embedding`, `transformer.resblocks.{i}`,
`ln_final`, `text_projection`, `logit_scale`), so the state dict feeds the
JAX package's `models/clip/convert.py from_openclip`.
Pre-LN transformers; LayerNorms in fp32 keep the residual stream fp32 while
every matmul runs in its weight's dtype. The image tower has a class token
and a stride = kernel convolution as patch embedding (non-overlapping
patches). The text tower runs under a causal mask, so its attention always
takes the plain dot-product route (`ops/attention.flash_route`), and pools
at the end-of-text token, the largest id of each row. Token ids must lie
in [0, vocab_size): out-of-range ids raise a ValueError (JAX's gather would
clamp them silently, and a CUDA gather would fault). A config whose
`vision_layers` is a tuple (RN50 ... RN50x64) builds the ModifiedResNet
tower under the same `visual.` prefix.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from perceptor_tpu_torch.models.clip.configs import CLIPConfig
from perceptor_tpu_torch.models.clip.resnet import ModifiedResNet
from perceptor_tpu_torch.ops.attention import attention, causal_mask
from perceptor_tpu_torch.ops.layers import Conv2d, LayerNorm, Linear


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class MultiheadAttention(nn.Module):
    """Packed-qkv self-attention with nn.MultiheadAttention's param names."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = Linear(width, width)

    def forward(self, x, mask=None):
        b, s, width = x.shape
        w = self.in_proj_weight
        qkv = F.linear(x.to(w.dtype), w, self.in_proj_bias.to(w.dtype))
        qkv = qkv.view(b, s, 3, self.heads, width // self.heads).permute(2, 0, 3, 1, 4)
        out = attention(qkv[0], qkv[1], qkv[2], mask=mask)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, width))


class MLP(nn.Module):
    def __init__(self, width: int, quick: bool):
        super().__init__()
        self.quick = quick
        self.c_fc = Linear(width, width * 4)
        self.c_proj = Linear(width * 4, width)

    def forward(self, x):
        h = self.c_fc(x)
        h = quick_gelu(h) if self.quick else F.gelu(h)
        return self.c_proj(h)


class ResidualBlock(nn.Module):
    def __init__(self, width: int, heads: int, quick: bool):
        super().__init__()
        self.ln_1 = LayerNorm(width, eps=1e-5)
        self.attn = MultiheadAttention(width, heads)
        self.ln_2 = LayerNorm(width, eps=1e-5)
        self.mlp = MLP(width, quick)

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, quick: bool):
        super().__init__()
        self.resblocks = nn.ModuleList(
            [ResidualBlock(width, heads, quick) for _ in range(layers)]
        )

    def forward(self, x, mask=None):
        for block in self.resblocks:
            x = block(x, mask)
        return x


class VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        width, grid = cfg.vision_width, cfg.image_size[0] // cfg.patch_size
        self.patch_size = cfg.patch_size
        self.conv1 = Conv2d(3, width, cfg.patch_size, stride=cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty(grid * grid + 1, width))
        self.ln_pre = LayerNorm(width, eps=1e-5)
        self.transformer = Transformer(width, cfg.vision_layers, cfg.vision_heads, cfg.quick_gelu)
        self.ln_post = LayerNorm(width, eps=1e-5)
        self.proj = nn.Parameter(torch.empty(width, cfg.embed_dim))

    def forward(self, images):
        """images (N, 3, H, W), already resized and normalized -> (N, embed) fp32."""
        h, w = images.shape[-2:]
        if h % self.patch_size or w % self.patch_size:
            raise ValueError(f"image size ({h}, {w}) not divisible by patch {self.patch_size}")
        x = self.conv1(images)  # (N, width, gh, gw)
        n, width = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)
        dtype = x.dtype
        cls = self.class_embedding.to(dtype).expand(n, 1, width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dtype)
        x = self.transformer(self.ln_pre(x))
        x = self.ln_post(x[:, 0])
        return (x.to(self.proj.dtype) @ self.proj).float()


def checked_token_ids(tokens, vocab_size: int, device) -> torch.Tensor:
    """`tokens` as an int64 tensor on `device`; ids outside [0, vocab_size)
    raise (one host read-back, skipped while `torch.export` traces)."""
    tokens = torch.as_tensor(tokens, device=device).long()
    if tokens.numel() and not torch.compiler.is_exporting() and (int(tokens.min()) < 0 or int(tokens.max()) >= vocab_size):
        raise ValueError(
            f"token ids must lie in [0, {vocab_size}), got "
            f"[{int(tokens.min())}, {int(tokens.max())}]"
        )
    return tokens


class TextTransformer(nn.Module):
    """The text tower under open_clip's top-level names."""

    def __init__(self, config: CLIPConfig):
        super().__init__()
        self.config = config
        self._build_text(config)

    def _build_text(self, config: CLIPConfig) -> None:
        self.token_embedding = nn.Embedding(config.vocab_size, config.text_width)
        self.positional_embedding = nn.Parameter(
            torch.empty(config.context_length, config.text_width)
        )
        self.transformer = Transformer(
            config.text_width, config.text_layers, config.text_heads, config.quick_gelu
        )
        self.ln_final = LayerNorm(config.text_width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.empty(config.text_width, config.embed_dim))

    def encode_text(self, tokens):
        """tokens (N, S <= context_length) integer ids -> (N, embed) fp32,
        pooled at each row's largest id (the end-of-text token)."""
        weight = self.token_embedding.weight
        tokens = checked_token_ids(tokens, self.config.vocab_size, weight.device)
        seq = tokens.shape[1]
        x = self.token_embedding(tokens) + self.positional_embedding[:seq].to(weight.dtype)
        x = self.transformer(x, causal_mask(seq, device=weight.device))
        x = self.ln_final(x)
        pooled = x[torch.arange(x.shape[0], device=x.device), self.eot_positions(tokens)]
        proj = self.text_projection
        return (pooled.to(proj.dtype) @ proj).float()

    @staticmethod
    def eot_positions(tokens):
        """Each row's pooling position: its largest id (the end-of-text
        token)."""
        return tokens.argmax(dim=-1)

    def forward(self, tokens):
        return self.encode_text(tokens)


class CLIP(TextTransformer):
    """Both towers and `logit_scale`. As in open_clip the text tower's
    parameters sit at the top level, beside `visual`."""

    def __init__(self, config: CLIPConfig):
        nn.Module.__init__(self)
        self.config = config
        self.visual = (
            ModifiedResNet(config.vision_layers, config.embed_dim, config.vision_heads,
                           config.image_size[0], config.vision_width)
            if config.is_resnet else VisionTransformer(config)
        )
        self._build_text(config)
        self.logit_scale = nn.Parameter(torch.tensor(2.6592))

    def named_parameters(self, prefix: str = "", recurse: bool = True,
                         remove_duplicate: bool = True):
        """`visual.*` first, then the text tower and `logit_scale`: a seeded
        random fill (`core/init.py init_random_`) draws the image tower's
        weights first, whatever the text tower's size."""
        named = list(super().named_parameters(prefix, recurse, remove_duplicate))
        visual = (prefix + "." if prefix else "") + "visual."
        yield from (item for item in named if item[0].startswith(visual))
        yield from (item for item in named if not item[0].startswith(visual))

    @property
    def text(self):
        """The text tower as a callable, tokens -> features."""
        return self.encode_text

    def encode_image(self, images):
        return self.visual(images)

    def forward(self, images, tokens):
        return self.encode_image(images), self.encode_text(tokens), self.logit_scale
