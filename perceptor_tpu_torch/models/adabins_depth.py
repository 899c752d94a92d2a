"""AdaBins monocular depth over an EfficientNet trunk (counterpart of
perceptor_tpu/models/adabins_depth.py), NCHW.

- `EfficientNetFeatures`: gen-efficientnet's `tf_efficientnet_*` trunk
  (TF "SAME" padding, inference BatchNorm with eps 1e-3, swish or relu6,
  squeeze-excite of a quarter of each block's input width), returning the
  AdaBins Encoder's walk over it: input, stem conv, stem bn, stem act,
  stages 0-6, then conv_head. AdaBins reads walk entries (4, 5, 6, 8, 11),
  MiDaS v2.1-small (`models/midas_depth.py`) the outputs of stages 1, 2, 4
  and 6.
- `UnetAdaptiveBins`: the trunk, `DecoderBN` (its 1x1 `conv2` keeps the
  reference's padding of 1, so the map grows 2 px a side), the mini-ViT
  (`MiniViT`: a patch transformer of torch's post-norm encoder layers, with
  flax's LayerNorm eps 1e-6 as the JAX package has it) and the bin-center
  head.
- `predict(net, images, min_depth, max_depth)`: the wrapper's prediction
  over any network, flip-averaged, the flip branch NOT normalized (the
  reference's quirk, kept).
- `AdaBinsDepth`: `preresize` (the area-clamped pre-resize), then
  `predict`.

Precision as the JAX package computes it: its flax convolutions carry no
`dtype`, so they compute in fp32 even when the model's `dtype` is bf16;
the bf16 `dtype` only rounds the trunk's input. The port keeps every weight
in fp32 and rounds that input alone.

Module names are the upstream checkpoints' (gen-efficientnet under
`encoder.original_model`, the AdaBins repository's `decoder`,
`adaptive_bins_layer` and `conv_out.0`), so a state_dict of the port is what
the JAX package's `convert_efficientnet` and `convert_adabins` read. No
checkpoint is in the tree: the tiny model is seeded random, and the full
model refuses to build, as the JAX wrapper does without weights.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from perceptor_tpu_torch.core.init import random_module, resolve_device
from perceptor_tpu_torch.ops.layers import Conv2dSame, FrozenBatchNorm2d, LayerNorm
from perceptor_tpu_torch.ops.resize import interpolate_bilinear, resize
from perceptor_tpu_torch.utils.checkpoints import find_checkpoint, load_found

MAX_ADABINS_AREA = 500_000
MIN_ADABINS_AREA = 448 * 448

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

# the Encoder walk's entries that DecoderBN takes (stages 0, 1, 2, 4 and
# conv_head)
DECODER_TAPS = (4, 5, 6, 8, 11)


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One EfficientNet stage: `count` blocks, the first carries the stride."""

    kind: str  # "ds" (depthwise-separable) | "ir" (inverted residual)
    kernel: int
    stride: int
    expand: int
    channels: int
    count: int


# tf_efficientnet_b5: width 1.6 / depth 2.2 over the B0 template
B5_BLOCKS: Tuple[BlockSpec, ...] = (
    BlockSpec("ds", 3, 1, 1, 24, 3),
    BlockSpec("ir", 3, 2, 6, 40, 5),
    BlockSpec("ir", 5, 2, 6, 64, 5),
    BlockSpec("ir", 3, 2, 6, 128, 7),
    BlockSpec("ir", 5, 1, 6, 176, 7),
    BlockSpec("ir", 5, 2, 6, 304, 9),
    BlockSpec("ir", 3, 1, 6, 512, 3),
)


@dataclasses.dataclass(frozen=True)
class EfficientNetConfig:
    stem_channels: int = 48
    head_channels: int = 2048
    blocks: Tuple[BlockSpec, ...] = B5_BLOCKS
    se_ratio: float = 0.25
    bn_eps: float = 1e-3
    activation: str = "silu"  # "relu6" for lite variants
    use_se: bool = True  # lite variants drop squeeze-excite
    include_head: bool = True  # MiDaS-small taps stop before conv_head


@dataclasses.dataclass(frozen=True)
class AdaBinsConfig:
    encoder: EfficientNetConfig = EfficientNetConfig()
    n_bins: int = 256
    min_val: float = 1e-3
    max_val: float = 10.0
    decoder_features: int = 2048
    decoder_out: int = 128
    embedding_dim: int = 128
    n_query_channels: int = 128
    patch_size: int = 16
    transformer_layers: int = 4
    transformer_heads: int = 4
    transformer_ffn: int = 1024
    max_patches: int = 500


TINY_EFFICIENTNET = EfficientNetConfig(
    stem_channels=8,
    head_channels=32,
    blocks=(
        BlockSpec("ds", 3, 1, 1, 4, 1),
        BlockSpec("ir", 3, 2, 2, 6, 2),
        BlockSpec("ir", 5, 2, 2, 8, 1),
        BlockSpec("ir", 3, 2, 2, 12, 1),
        BlockSpec("ir", 5, 1, 2, 16, 1),
        BlockSpec("ir", 5, 2, 2, 20, 1),
        BlockSpec("ir", 3, 1, 2, 24, 1),
    ),
)
TINY_ADABINS = AdaBinsConfig(
    encoder=TINY_EFFICIENTNET,
    n_bins=10,
    decoder_features=32,
    decoder_out=16,
    embedding_dim=16,
    n_query_channels=16,
    patch_size=2,
    transformer_layers=2,
    transformer_heads=2,
    transformer_ffn=32,
)


def _act(name: str):
    if name == "silu":
        return F.silu
    if name == "relu6":
        return F.relu6
    raise ValueError(f"unknown efficientnet activation: {name}")


class Activation(nn.Module):
    """`_act(name)` as a module, for the trunk's Sequential layout."""

    def __init__(self, name: str):
        super().__init__()
        self.fn = _act(name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)


class SqueezeExcite(nn.Module):
    """SE over the global mean (gen-efficientnet: the reduced width is a
    quarter of the block's INPUT channels)."""

    def __init__(self, channels: int, reduced: int):
        super().__init__()
        self.conv_reduce = nn.Conv2d(channels, reduced, 1)
        self.conv_expand = nn.Conv2d(reduced, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.conv_expand(F.silu(self.conv_reduce(x.mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(s)


def _se(channels: int, in_channels: int, cfg: EfficientNetConfig):
    return SqueezeExcite(channels, max(1, int(in_channels * cfg.se_ratio))) if cfg.use_se else None


class DepthwiseSeparable(nn.Module):
    """gen-efficientnet DepthwiseSeparableConv: dw -> bn -> act -> [SE] ->
    pw -> bn, residual when stride 1 and the widths match."""

    def __init__(self, spec: BlockSpec, in_channels: int, cfg: EfficientNetConfig):
        super().__init__()
        self.act = _act(cfg.activation)
        self.residual = spec.stride == 1 and in_channels == spec.channels
        self.conv_dw = Conv2dSame(in_channels, in_channels, spec.kernel, spec.stride,
                                  groups=in_channels, bias=False)
        self.bn1 = FrozenBatchNorm2d(in_channels, cfg.bn_eps)
        self.se = _se(in_channels, in_channels, cfg)
        self.conv_pw = nn.Conv2d(in_channels, spec.channels, 1, bias=False)
        self.bn2 = FrozenBatchNorm2d(spec.channels, cfg.bn_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.act(self.bn1(self.conv_dw(x)))
        if self.se is not None:
            h = self.se(h)
        h = self.bn2(self.conv_pw(h))
        return h + x if self.residual else h


class InvertedResidual(nn.Module):
    """gen-efficientnet InvertedResidual (MBConv): pw-expand -> dw -> [SE] ->
    pw-linear, residual when stride 1 and the widths match."""

    def __init__(self, spec: BlockSpec, in_channels: int, cfg: EfficientNetConfig):
        super().__init__()
        mid = in_channels * spec.expand
        self.act = _act(cfg.activation)
        self.residual = spec.stride == 1 and in_channels == spec.channels
        self.conv_pw = nn.Conv2d(in_channels, mid, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(mid, cfg.bn_eps)
        self.conv_dw = Conv2dSame(mid, mid, spec.kernel, spec.stride, groups=mid, bias=False)
        self.bn2 = FrozenBatchNorm2d(mid, cfg.bn_eps)
        self.se = _se(mid, in_channels, cfg)
        self.conv_pwl = nn.Conv2d(mid, spec.channels, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(spec.channels, cfg.bn_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.act(self.bn1(self.conv_pw(x)))
        h = self.act(self.bn2(self.conv_dw(h)))
        if self.se is not None:
            h = self.se(h)
        h = self.bn3(self.conv_pwl(h))
        return h + x if self.residual else h


class EfficientNetFeatures(nn.Module):
    """The trunk (gen-efficientnet names: `conv_stem`, `bn1`, `act1`,
    `blocks.{stage}.{i}`, `conv_head`); `forward` returns the Encoder's walk
    as fp32 NCHW maps. `dtype` rounds the input before the fp32 stem, as
    the JAX module's `dtype` does."""

    def __init__(self, config: EfficientNetConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        self.dtype = dtype
        self.conv_stem = Conv2dSame(3, cfg.stem_channels, 3, 2, bias=False)
        self.bn1 = FrozenBatchNorm2d(cfg.stem_channels, cfg.bn_eps)
        self.act1 = Activation(cfg.activation)
        stages, in_ch = [], cfg.stem_channels
        for spec in cfg.blocks:
            blocks = []
            for i in range(spec.count):
                block_spec = spec if i == 0 else dataclasses.replace(spec, stride=1)
                cls = DepthwiseSeparable if spec.kind == "ds" else InvertedResidual
                blocks.append(cls(block_spec, in_ch, cfg))
                in_ch = spec.channels
            stages.append(nn.Sequential(*blocks))
        self.blocks = nn.Sequential(*stages)
        self.conv_head = (nn.Conv2d(in_ch, cfg.head_channels, 1, bias=False)
                          if cfg.include_head else None)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        features = [x]
        h = x.to(self.dtype).float()
        for layer in (self.conv_stem, self.bn1, self.act1, *self.blocks):
            h = layer(h)
            features.append(h)
        if self.conv_head is not None:
            features.append(self.conv_head(h))
        return features


class Encoder(nn.Module):
    """The AdaBins Encoder: the trunk under `original_model`."""

    def __init__(self, backend: EfficientNetFeatures):
        super().__init__()
        self.original_model = backend

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self.original_model(x)


class UpSampleBN(nn.Module):
    """Align-corners bilinear upsample to the skip's size, concat, then
    twice conv3x3 -> BatchNorm -> LeakyReLU (names `_net.{0,1,3,4}`)."""

    def __init__(self, skip_input: int, features: int, bn_eps: float = 1e-5):
        super().__init__()
        self._net = nn.Sequential(
            nn.Conv2d(skip_input, features, 3, padding=1), FrozenBatchNorm2d(features, bn_eps),
            nn.LeakyReLU(0.01),
            nn.Conv2d(features, features, 3, padding=1), FrozenBatchNorm2d(features, bn_eps),
            nn.LeakyReLU(0.01),
        )

    def forward(self, x: torch.Tensor, concat_with: torch.Tensor) -> torch.Tensor:
        up = interpolate_bilinear(x, concat_with.shape[-2:], align_corners=True)
        return self._net(torch.cat([up, concat_with], dim=1))


class DecoderBN(nn.Module):
    """`conv2` (1x1 with the reference's padding of 1), four `UpSampleBN`
    over the skips, `conv3`. `skip_channels` are the widths of block0 ..
    block3, `in_channels` block4's."""

    def __init__(self, in_channels: int, features: int, num_classes: int,
                 skip_channels: Sequence[int], bn_eps: float = 1e-5):
        super().__init__()
        f = features
        self.conv2 = nn.Conv2d(in_channels, f, 1, padding=1)
        self.up1 = UpSampleBN(f + skip_channels[3], f // 2, bn_eps)
        self.up2 = UpSampleBN(f // 2 + skip_channels[2], f // 4, bn_eps)
        self.up3 = UpSampleBN(f // 4 + skip_channels[1], f // 8, bn_eps)
        self.up4 = UpSampleBN(f // 8 + skip_channels[0], f // 16, bn_eps)
        self.conv3 = nn.Conv2d(f // 16, num_classes, 3, padding=1)

    def forward(self, block0, block1, block2, block3, block4) -> torch.Tensor:
        x = self.conv2(block4)
        x = self.up1(x, block3)
        x = self.up2(x, block2)
        x = self.up3(x, block1)
        return self.conv3(self.up4(x, block0))


class SelfAttention(nn.Module):
    """torch MultiheadAttention's parameters (`in_proj_weight`,
    `in_proj_bias`, `out_proj`) over (N, S, E), its softmax written out."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, s, e = x.shape
        d = e // self.heads
        q, k, v = (t.reshape(n, s, self.heads, d).transpose(1, 2)
                   for t in F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1))
        attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d), dim=-1)
        return self.out_proj((attn @ v).transpose(1, 2).reshape(n, s, e))


class TorchTransformerLayer(nn.Module):
    """torch nn.TransformerEncoderLayer, post-norm, relu FFN, (N, S, E);
    LayerNorm eps 1e-6 (flax's default, which the JAX package keeps)."""

    def __init__(self, width: int, heads: int, ffn: int):
        super().__init__()
        self.self_attn = SelfAttention(width, heads)
        self.linear1 = nn.Linear(width, ffn)
        self.linear2 = nn.Linear(ffn, width)
        self.norm1 = LayerNorm(width, eps=1e-6)
        self.norm2 = LayerNorm(width, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.self_attn(x))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


class TransformerEncoder(nn.Module):
    def __init__(self, config: AdaBinsConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            TorchTransformerLayer(config.embedding_dim, config.transformer_heads,
                                  config.transformer_ffn)
            for _ in range(config.transformer_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class PatchTransformerEncoder(nn.Module):
    """A valid-padding patch conv, learned positional encodings (the first
    S of `max_patches` rows), the transformer layers; NCHW in, (N, S, E)
    out."""

    def __init__(self, in_channels: int, config: AdaBinsConfig):
        super().__init__()
        p, e = config.patch_size, config.embedding_dim
        self.embedding_convPxP = nn.Conv2d(in_channels, e, p, stride=p)
        self.positional_encodings = nn.Parameter(torch.empty(config.max_patches, e))
        self.transformer_encoder = TransformerEncoder(config)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tokens = self.embedding_convPxP(x).flatten(2).transpose(1, 2)
        tokens = tokens + self.positional_encodings[None, : tokens.shape[1]]
        return self.transformer_encoder(tokens)


class MiniViT(nn.Module):
    """mViT: (normalized bin widths (N, n_bins), range-attention maps
    (N, n_query_channels, H, W))."""

    def __init__(self, in_channels: int, config: AdaBinsConfig):
        super().__init__()
        self.n_query_channels = config.n_query_channels
        self.patch_transformer = PatchTransformerEncoder(in_channels, config)
        self.conv3x3 = nn.Conv2d(in_channels, config.embedding_dim, 3, padding=1)
        self.regressor = nn.Sequential(
            nn.Linear(config.embedding_dim, 256), nn.LeakyReLU(0.01),
            nn.Linear(256, 256), nn.LeakyReLU(0.01),
            nn.Linear(256, config.n_bins),
        )

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        tokens = self.patch_transformer(x)
        keys = self.conv3x3(x)
        queries = tokens[:, 1 : self.n_query_channels + 1]
        maps = torch.einsum("nchw,nqc->nqhw", keys, queries)  # pixel-wise dot product
        y = F.relu(self.regressor(tokens[:, 0])) + 0.1  # norm="linear"
        return y / y.sum(dim=1, keepdim=True), maps


class UnetAdaptiveBins(nn.Module):
    """ImageNet-normalized NCHW images -> (bin edges (N, n_bins + 1), depth
    (N, 1, H/2, W/2)); the depth is the softmax-weighted sum of bin
    centers."""

    def __init__(self, config: AdaBinsConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg, enc = config, config.encoder
        self.config = cfg
        self.encoder = Encoder(EfficientNetFeatures(enc, dtype))
        self.decoder = DecoderBN(
            enc.head_channels, cfg.decoder_features, cfg.decoder_out,
            tuple(enc.blocks[s].channels for s in (0, 1, 2, 4)))
        self.adaptive_bins_layer = MiniViT(cfg.decoder_out, cfg)
        self.conv_out = nn.Sequential(nn.Conv2d(cfg.n_query_channels, cfg.n_bins, 1))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.config
        features = self.encoder(x)
        unet_out = self.decoder(*(features[i] for i in DECODER_TAPS))
        widths_normed, maps = self.adaptive_bins_layer(unet_out)
        out = torch.softmax(self.conv_out(maps), dim=1)
        widths = F.pad((cfg.max_val - cfg.min_val) * widths_normed, (1, 0), value=cfg.min_val)
        edges = torch.cumsum(widths, dim=1)
        centers = 0.5 * (edges[:, :-1] + edges[:, 1:])
        pred = torch.einsum("nchw,nc->nhw", out, centers)[:, None]
        return edges, pred.float()


def predict(net: UnetAdaptiveBins, images: torch.Tensor, min_depth: float,
            max_depth: float) -> torch.Tensor:
    """The reference's inference over `net`: images (N, 3, H, W) in [0, 1]
    -> depth (N, 1, H, W), the mean of the normalized image's prediction and
    the mirrored prediction of the mirrored image, which the reference feeds
    UN-normalized (kept); clamped, upsampled align-corners, clamped."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=images.device)[None, :, None, None]
    std = torch.as_tensor(IMAGENET_STD, device=images.device)[None, :, None, None]

    def run(x):
        return net(x)[1].clamp(min_depth, max_depth)

    final = (run((images - mean) / std) + run(images.flip(-1)).flip(-1)) / 2.0
    final = interpolate_bilinear(final, images.shape[-2:], align_corners=True)
    return final.clamp(min_depth, max_depth)


def preresize(images: torch.Tensor) -> torch.Tensor:
    """The reference's pre-resize by area: lanczos3 down above 500,000 px,
    bicubic up below 448^2, the aspect kept; other sizes pass."""
    h, w = images.shape[-2:]
    area = h * w
    if MIN_ADABINS_AREA <= area <= MAX_ADABINS_AREA:
        return images
    bound, resample = ((MAX_ADABINS_AREA, "lanczos3") if area > MAX_ADABINS_AREA
                       else (MIN_ADABINS_AREA, "bicubic"))
    scale = float(np.sqrt(bound) / np.sqrt(area))
    return resize(images, out_shape=(int(h * scale), int(w * scale)), resample=resample)


DATASETS = {
    "nyu": dict(min_depth=1e-3, max_depth=10.0),
    "kitti": dict(min_depth=1e-3, max_depth=80.0),
}


class AdaBinsDepth:
    """AdaBins depth: `images (N, 3, H, W) in [0, 1] -> depth (N, 1, H, W)`
    through `predict` over a `UnetAdaptiveBins` whose trunk input is
    rounded to bf16, as the JAX wrapper's. The full-width model loads the
    checkpoint `find_checkpoint("AdaBins_<name>", "adabins_<name>")` finds
    and, as JAX's, refuses to run without one; `tiny` is seeded random."""

    def __init__(self, name: str = "nyu", tiny: bool = False, device="cuda"):
        if name not in DATASETS:
            raise ValueError(f"unknown adabins checkpoint: {name}")
        self.name = name
        self.tiny = tiny
        self.min_depth = DATASETS[name]["min_depth"]
        self.max_depth = DATASETS[name]["max_depth"]
        path = None if tiny else find_checkpoint(f"AdaBins_{name}", f"adabins_{name}")
        if not tiny and path is None:
            raise NotImplementedError(
                f"AdaBins_{name} weights not found in the checkpoint cache; the full-width "
                "model needs the reference checkpoint")
        self.config = TINY_ADABINS if tiny else AdaBinsConfig(min_val=self.min_depth,
                                                              max_val=self.max_depth)
        self.device = resolve_device(device)
        generator = torch.Generator(device=self.device).manual_seed(0)
        self.module = random_module(
            lambda cfg: UnetAdaptiveBins(cfg, dtype=torch.bfloat16), self.config, self.device,
            generator, torch.float32)
        if path is not None:
            load_found(path, {"module": self.module}, self._from_jax, self.load_state_dict)

    def _from_jax(self, params) -> Dict[str, Dict[str, torch.Tensor]]:
        from perceptor_tpu_torch.convert import adabins_state_dict_from_jax

        return {"module": adabins_state_dict_from_jax(params, self.config)}

    def load_state_dict(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        self.module.load_state_dict(state_dict)

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        images = torch.as_tensor(images, dtype=torch.float32)
        if not self.tiny:
            images = preresize(images)
        return predict(self.module, images, self.min_depth, self.max_depth)
