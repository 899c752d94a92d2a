"""MiDaS / DPT monocular depth (counterpart of
perceptor_tpu/models/midas_depth.py), NCHW.

All six reference checkpoints' architectures, at published widths:
- dpt_large: `DPTViT` (timm ViT-L/16 at 384px: cls + pos, 24 pre-LN
  blocks, taps after blocks 5 / 11 / 17 / 23);
- dpt_hybrid, dpt_hybrid_nyu, dpt_hybrid_kitti: `DPTHybridViT` (timm's
  ResNetV2 stem, stages (3, 4, 9) of weight-standardized convs and
  GroupNorm 32, a 1x1 token projection of its 1/16 map, 12 blocks);
- both under `DPTDepthModel`: the project readout, reassembly (1x1 conv,
  then a ConvTranspose2d of kernel = stride or a 3x3/2 conv), the scratch
  3x3 convs, RefineNet fusion with align-corners 2x upsampling, the head;
- midas_v21: `MidasNet` over `models/resnet.ResNetFeatures` at
  ResNeXt-101 32x8d, v1 fusion blocks whose residual adds relu(x) (the
  reference's in-place ReLU, kept);
- midas_v21_small: `MidasNetSmall` over `models/adabins_depth`'s
  EfficientNet trunk at tf_efficientnet_lite3, fusion blocks whose residual
  adds the true x.

The v2.1 heads upsample with align_corners=False, everything else with
align_corners=True. TF "SAME" padding (`ops/layers.pad_same`) where the JAX
code pads "SAME": the hybrid stem's convs and its -inf-padded max pool, and
the EfficientNet trunk.

Precision follows what the JAX modules compute in, layer by layer, with
`dtype` bf16 (`optimize=True`): the ViT and the DPT and v2.1 scratch and
heads compute in bf16 (their weights stored in bf16); LayerNorm and
GroupNorm compute in fp32; the v2.1 CNN trunks compute in fp32 on the input
rounded to bf16 (their flax convolutions carry no dtype). One deliberate
difference: the hybrid's ResNetV2 stem computes in fp32 on the unrounded
input, where JAX rounds the input and computes its StdConvs in bf16 (see
`DPTHybridViT`).

Module names are the upstream checkpoints' (`pretrained.model.*` for
timm's ViT, `pretrained.act_postprocess{k}.{0,3,4}`, `pretrained.layer{k}`
for MiDaS's regrouped CNN trunks, `scratch.*`), so a state_dict of the port
is what the JAX package's `convert_dpt`, `convert_midas_net` and
`convert_midas_net_small` read. The JAX package's MXU layout of the patch
embedding (`models/patch_embed.py`) is a strided conv here, and its
matmul form of the ConvTranspose2d a ConvTranspose2d. Unused upstream
parameters that JAX's converters drop (refinenet4's first residual unit in
the v2.1 models) are not built. No checkpoint is in the tree: `MidasDepth`
builds seeded random weights at published widths, as the JAX wrapper does
when it finds none.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from perceptor_tpu_torch.core.dtypes import COMPUTE_DTYPE, cast_matmul_params_bf16
from perceptor_tpu_torch.core.init import random_module, resolve_device
from perceptor_tpu_torch.models.adabins_depth import (
    IMAGENET_MEAN, IMAGENET_STD, BlockSpec, EfficientNetConfig, EfficientNetFeatures)
from perceptor_tpu_torch.models.resnet import (
    RESNEXT101_32X8D, TINY_RESNEXT, ResNetConfig, ResNetFeatures)
from perceptor_tpu_torch.ops.attention import attention
from perceptor_tpu_torch.ops.layers import (
    Conv2d, ConvTranspose2d, GroupNorm, LayerNorm, Linear, pad_same)
from perceptor_tpu_torch.ops.resize import interpolate_bilinear, resize
from perceptor_tpu_torch.utils.cache import cache
from perceptor_tpu_torch.utils.checkpoints import find_checkpoint, load_found


@dataclasses.dataclass(frozen=True)
class ResNetV2StemConfig:
    """timm ResNetV2 trunk of vit_base_r50_s16_384: StdConv + GroupNorm32,
    "SAME" padding, post-norm bottlenecks, layers (3, 4, 9)."""

    layers: tuple = (3, 4, 9)
    stem_width: int = 64
    widths: tuple = (256, 512, 1024)
    gn_groups: int = 32


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    image_size: int = 384
    patch_size: int = 16
    vit_width: int = 1024
    vit_layers: int = 24
    vit_heads: int = 16
    hooks: tuple = (5, 11, 17, 23)
    reassemble_features: tuple = (256, 512, 1024, 1024)
    features: int = 256
    stem: Optional[ResNetV2StemConfig] = None  # set => hybrid (vitb_rn50_384)

    @property
    def hybrid(self) -> bool:
        return self.stem is not None


TINY = DPTConfig(
    image_size=64, patch_size=16, vit_width=32, vit_layers=4, vit_heads=2,
    hooks=(0, 1, 2, 3), reassemble_features=(8, 16, 32, 32), features=16,
)
DPT_HYBRID = DPTConfig(
    vit_width=768, vit_layers=12, vit_heads=12, hooks=(0, 1, 8, 11),
    reassemble_features=(256, 512, 768, 768), stem=ResNetV2StemConfig(),
)
TINY_HYBRID = DPTConfig(
    image_size=64, vit_width=24, vit_layers=4, vit_heads=2,
    hooks=(0, 1, 2, 3), reassemble_features=(8, 16, 24, 24), features=16,
    stem=ResNetV2StemConfig(layers=(1, 1, 1), stem_width=8, widths=(8, 16, 32), gn_groups=2),
)
CONFIGS = {
    "dpt_large": DPTConfig(),
    "dpt_hybrid": DPT_HYBRID,
    "dpt_hybrid_nyu": DPT_HYBRID,
    "dpt_hybrid_kitti": DPT_HYBRID,
    "tiny": TINY,
    "tiny_hybrid": TINY_HYBRID,
}
CHECKPOINT_NAMES = (
    "midas_v21_small", "midas_v21", "dpt_large", "dpt_hybrid",
    "dpt_hybrid_nyu", "dpt_hybrid_kitti", "tiny",
)
TEST_NAMES = ("tiny_v21", "tiny_hybrid", "tiny_v21_small")


# -- timm ViT and its hybrid stem ---------------------------------------------


class StdConv(nn.Module):
    """timm StdConv2dSame without bias, fp32: the weight standardized per
    output channel (biased variance, eps 1e-6), TF "SAME" padding."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel, kernel))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.float()
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        var = (w - mean).square().mean(dim=(1, 2, 3), keepdim=True)
        w = (w - mean) * torch.rsqrt(var + 1e-6)
        return F.conv2d(pad_same(x.float(), w.shape[-1], self.stride), w, stride=self.stride)


class Downsample(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int, gn_groups: int):
        super().__init__()
        self.conv = StdConv(in_channels, out_channels, 1, stride)
        self.norm = GroupNorm(out_channels, 1e-5, gn_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.conv(x))


class ResNetV2Bottleneck(nn.Module):
    """timm resnetv2 Bottleneck (preact=False): StdConv 1x1 -> GN + relu ->
    StdConv 3x3 carrying the stride -> GN + relu -> StdConv 1x1 -> GN,
    relu(out + shortcut)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int, gn_groups: int):
        super().__init__()
        mid = out_channels // 4
        self.downsample = None
        if stride != 1 or in_channels != out_channels:
            self.downsample = Downsample(in_channels, out_channels, stride, gn_groups)
        self.conv1 = StdConv(in_channels, mid, 1)
        self.norm1 = GroupNorm(mid, 1e-5, gn_groups)
        self.conv2 = StdConv(mid, mid, 3, stride)
        self.norm2 = GroupNorm(mid, 1e-5, gn_groups)
        self.conv3 = StdConv(mid, out_channels, 1)
        self.norm3 = GroupNorm(out_channels, 1e-5, gn_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.downsample is None else self.downsample(x)
        h = F.relu(self.norm1(self.conv1(x)))
        h = F.relu(self.norm2(self.conv2(h)))
        return F.relu(self.norm3(self.conv3(h)) + shortcut)


class ResNetStage(nn.Module):
    def __init__(self, blocks: Sequence[nn.Module]):
        super().__init__()
        self.blocks = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.blocks(x)


class ResNetV2Stem(nn.Module):
    """The hybrid ViT's CNN trunk (names `stem.{conv,norm}`,
    `stages.{s}.blocks.{i}`); NCHW in, the (1/4, 1/8, 1/16) stage maps out,
    fp32."""

    def __init__(self, config: ResNetV2StemConfig):
        super().__init__()
        cfg = config
        self.stem = nn.ModuleDict({
            "conv": StdConv(3, cfg.stem_width, 7, 2),
            "norm": GroupNorm(cfg.stem_width, 1e-5, cfg.gn_groups),
        })
        stages, in_ch = [], cfg.stem_width
        for s, (width, count) in enumerate(zip(cfg.widths, cfg.layers)):
            blocks = []
            for i in range(count):
                blocks.append(ResNetV2Bottleneck(in_ch, width, 2 if (s > 0 and i == 0) else 1,
                                                 cfg.gn_groups))
                in_ch = width
            stages.append(ResNetStage(blocks))
        self.stages = nn.ModuleList(stages)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = F.relu(self.stem["norm"](self.stem["conv"](x)))
        h = F.max_pool2d(pad_same(h, 3, 2, value=float("-inf")), 3, stride=2)
        outs = []
        for stage in self.stages:
            h = stage(h)
            outs.append(h)
        return outs


class Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(width, width * 3)
        self.proj = Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, s, w = x.shape
        qkv = self.qkv(x).reshape(n, s, 3, self.heads, w // self.heads).permute(2, 0, 3, 1, 4)
        out = attention(qkv[0], qkv[1], qkv[2])
        return self.proj(out.transpose(1, 2).reshape(n, s, w))


class Mlp(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.fc1 = Linear(width, width * 4)
        self.fc2 = Linear(width * 4, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """timm ViT block, pre-LN (eps 1e-6, fp32); the residual stream keeps
    the patch embedding's dtype."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.norm1 = LayerNorm(width, eps=1e-6)
        self.attn = Attention(width, heads)
        self.norm2 = LayerNorm(width, eps=1e-6)
        self.mlp = Mlp(width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    """`proj`: the 16x16/16 patch conv, or the hybrid's 1x1 conv over its
    `backbone`'s 1/16 map."""

    def __init__(self, proj: nn.Module, backbone: Optional[ResNetV2Stem] = None):
        super().__init__()
        if backbone is not None:
            self.backbone = backbone
        self.proj = proj


class DPTViT(nn.Module):
    """timm ViT returning the block outputs at `config.hooks` (with the cls
    token, fp32) and the token grid."""

    def __init__(self, config: DPTConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        self.config, self.dtype = cfg, dtype
        self.patch_embed = self._patch_embed()
        grid = cfg.image_size // cfg.patch_size
        self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.vit_width))
        self.pos_embed = nn.Parameter(torch.empty(1, grid * grid + 1, cfg.vit_width))
        self.blocks = nn.ModuleList(Block(cfg.vit_width, cfg.vit_heads)
                                    for _ in range(cfg.vit_layers))

    def _patch_embed(self) -> PatchEmbed:
        p = self.config.patch_size
        return PatchEmbed(Conv2d(3, self.config.vit_width, p, stride=p))

    def tokens(self, fmap: torch.Tensor, hooks) -> List[torch.Tensor]:
        """The embedded (N, W, gh, gw) map with cls and pos through the
        blocks: the outputs of the blocks in `hooks`."""
        x = fmap.flatten(2).transpose(1, 2)
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        taps = []
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i in hooks:
                taps.append(x.float())
        return taps

    def forward(self, images: torch.Tensor):
        fmap = self.patch_embed.proj(images.to(self.dtype))
        return self.tokens(fmap, self.config.hooks), tuple(fmap.shape[-2:])


class DPTHybridViT(DPTViT):
    """vit_base_r50_s16_384: the ResNetV2 stem, a 1x1 token projection of
    its 1/16 map, cls + pos, the blocks; returns the stem's (1/4, 1/8) maps,
    the token taps at hooks[2:] and the grid."""

    def _patch_embed(self) -> PatchEmbed:
        # The stem computes in fp32 on the unrounded input, where the JAX
        # module rounds the input to `dtype` and computes its StdConvs in
        # bf16. With seeded random weights its 16 GroupNorm bottlenecks
        # amplify a perturbation about twentyfold: bf16 StdConvs take the
        # last stage's output 35 % (relative L2) from fp32 and the depth
        # 5.5 % (H100) to 12.6 % (CPU); rounding the input alone still
        # moves the depth 5.2 %; this fp32 stem leaves 0.8 % (CPU).
        cfg = self.config
        return PatchEmbed(Conv2d(cfg.stem.widths[2], cfg.vit_width, 1), ResNetV2Stem(cfg.stem))

    def forward(self, images: torch.Tensor):
        c0, c1, c2 = self.patch_embed.backbone(images)
        fmap = self.patch_embed.proj(c2)
        return (c0, c1), self.tokens(fmap, self.config.hooks[2:]), tuple(fmap.shape[-2:])


# -- the scratch: RefineNet fusion and the head --------------------------------


class Interpolate(nn.Module):
    """2x bilinear upsampling (`ops/resize.interpolate_bilinear`)."""

    def __init__(self, align_corners: bool):
        super().__init__()
        self.align_corners = align_corners

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        return interpolate_bilinear(x, (2 * h, 2 * w), self.align_corners)


class ResidualConvUnit(nn.Module):
    """relu -> conv3x3 -> relu -> conv3x3, plus the skip: relu(x) where the
    reference's ReLU is in place (v1, `gated_skip`), else x."""

    def __init__(self, width: int, gated_skip: bool):
        super().__init__()
        self.gated_skip = gated_skip
        self.conv1 = Conv2d(width, width, 3, padding=1)
        self.conv2 = Conv2d(width, width, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gated = F.relu(x)
        out = self.conv2(F.relu(self.conv1(gated)))
        return out + (gated if self.gated_skip else x)


class FeatureFusionBlock(nn.Module):
    """x (+ resConfUnit1(skip)) -> resConfUnit2 -> align-corners 2x
    upsample -> [out_conv 1x1]."""

    def __init__(self, width: int, out_width: Optional[int], lateral: bool, gated_skip: bool):
        super().__init__()
        if lateral:
            self.resConfUnit1 = ResidualConvUnit(width, gated_skip)
        self.resConfUnit2 = ResidualConvUnit(width, gated_skip)
        self.out_conv = None if out_width is None else Conv2d(width, out_width, 1)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        h, w = x.shape[-2:]
        x = interpolate_bilinear(self.resConfUnit2(x), (2 * h, 2 * w), align_corners=True)
        return x if self.out_conv is None else self.out_conv(x)


class Scratch(nn.Module):
    """`layer{k}_rn` 3x3 convs (no bias) from the trunk's four maps to
    `widths`, `refinenet4` .. `refinenet1` (out widths `out_widths`, None
    for none) and `output_conv`: conv3x3 to `head_width`, 2x upsample,
    conv3x3 to 32, relu, conv1x1 to 1, relu when `non_negative`. Returns the
    (N, H, W) depth in fp32."""

    def __init__(self, in_widths: Sequence[int], widths: Sequence[int],
                 out_widths: Sequence[Optional[int]], head_width: int,
                 head_align_corners: bool, gated_skip: bool, non_negative: bool):
        super().__init__()
        for j in range(4):
            self.add_module(f"layer{j + 1}_rn",
                            Conv2d(in_widths[j], widths[j], 3, padding=1, bias=False))
            self.add_module(f"refinenet{j + 1}", FeatureFusionBlock(
                widths[j], out_widths[j], lateral=j < 3, gated_skip=gated_skip))
        head_in = out_widths[0] or widths[0]
        self.output_conv = nn.Sequential(
            Conv2d(head_in, head_width, 3, padding=1), Interpolate(head_align_corners),
            Conv2d(head_width, 32, 3, padding=1), nn.ReLU(), Conv2d(32, 1, 1),
            nn.ReLU() if non_negative else nn.Identity(),
        )

    def forward(self, layers: Sequence[torch.Tensor]) -> torch.Tensor:
        rn = [getattr(self, f"layer{j + 1}_rn")(layers[j]) for j in range(4)]
        path = self.refinenet4(rn[3])
        path = self.refinenet3(path, rn[2])
        path = self.refinenet2(path, rn[1])
        path = self.refinenet1(path, rn[0])
        return self.output_conv(path)[:, 0].float()


class ProjectReadout(nn.Module):
    """cat(tokens, cls) -> linear -> gelu (`project.0`)."""

    def __init__(self, width: int):
        super().__init__()
        self.project = nn.Sequential(Linear(2 * width, width), nn.GELU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tokens = x[:, 1:]
        return self.project(torch.cat([tokens, x[:, :1].expand_as(tokens)], dim=-1))


class DPTPretrained(nn.Module):
    """`model` (the ViT) and `act_postprocess{k}` for each token tap: the
    readout [0], a 1x1 conv [3] and the resampling [4] (a 4x and a 2x
    ConvTranspose2d, none, a 3x3/2 conv); positions 1 and 2 (the
    reference's transpose and unflatten) hold no parameters."""

    def __init__(self, config: DPTConfig, dtype: torch.dtype):
        super().__init__()
        cfg = config
        self.model = (DPTHybridViT if cfg.hybrid else DPTViT)(cfg, dtype)
        w, feats = cfg.vit_width, cfg.reassemble_features
        resample = (ConvTranspose2d(feats[0], feats[0], 4, stride=4),
                    ConvTranspose2d(feats[1], feats[1], 2, stride=2), None,
                    Conv2d(feats[3], feats[3], 3, stride=2, padding=1))
        for idx in range(2 if cfg.hybrid else 0, 4):
            layers = [ProjectReadout(w), nn.Identity(), nn.Identity(), Conv2d(w, feats[idx], 1)]
            if resample[idx] is not None:
                layers.append(resample[idx])
            self.add_module(f"act_postprocess{idx + 1}", nn.Sequential(*layers))


class DPTDepthModel(nn.Module):
    """Normalized NCHW images -> depth (N, H, W), fp32."""

    def __init__(self, config: DPTConfig, non_negative: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        self.config = cfg
        self.pretrained = DPTPretrained(cfg, dtype)
        in_widths = ((*cfg.stem.widths[:2], *cfg.reassemble_features[2:]) if cfg.hybrid
                     else cfg.reassemble_features)
        f = cfg.features
        self.scratch = Scratch(in_widths, (f,) * 4, (f,) * 4, f // 2, head_align_corners=True,
                               gated_skip=False, non_negative=non_negative)
        if dtype == COMPUTE_DTYPE:
            cast_matmul_params_bf16(self)
            if cfg.hybrid:  # its stem computes in fp32 (DPTHybridViT)
                self.pretrained.model.patch_embed.backbone.float()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        if self.config.hybrid:
            spatial, taps, (gh, gw) = self.pretrained.model(images)
            layers = list(spatial)  # act_postprocess1 / 2 are the identity
        else:
            layers, (taps, (gh, gw)) = [], self.pretrained.model(images)
        for idx, tap in enumerate(taps, start=len(layers)):
            post = getattr(self.pretrained, f"act_postprocess{idx + 1}")
            tokens = post[0](tap)
            fmap = tokens.transpose(1, 2).reshape(tokens.shape[0], -1, gh, gw)
            for layer in post[3:]:
                fmap = layer(fmap)
            layers.append(fmap)
        return self.scratch(layers)


# -- MiDaS v2.1 CNNs -----------------------------------------------------------


class Stages(nn.Module):
    """`pretrained`: a CNN trunk regrouped into `layer1` .. `layer4` as
    MiDaS's `_make_*_backbone` does; returns the four maps."""

    def __init__(self, *layers: nn.Module):
        super().__init__()
        for j, layer in enumerate(layers):
            self.add_module(f"layer{j + 1}", layer)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        maps = []
        for layer in self.children():
            x = layer(x)
            maps.append(x)
        return maps


@dataclasses.dataclass(frozen=True)
class MidasNetConfig:
    backbone: ResNetConfig = RESNEXT101_32X8D
    features: int = 256
    image_size: int = 384


class MidasNet(nn.Module):
    """MiDaS v2.1: the ResNeXt trunk (fp32, its input rounded to `dtype`),
    3x3 scratch convs, v1 fusion blocks (no out_conv), the head.
    ImageNet-normalized NCHW in, (N, H, W) depth out."""

    def __init__(self, config: MidasNetConfig, non_negative: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        self.dtype = dtype
        trunk = ResNetFeatures(cfg.backbone)
        self.pretrained = Stages(
            nn.Sequential(trunk.conv1, trunk.bn1, nn.ReLU(), nn.MaxPool2d(3, 2, 1), trunk.layer1),
            trunk.layer2, trunk.layer3, trunk.layer4)
        self.scratch = Scratch(cfg.backbone.stage_channels, (cfg.features,) * 4, (None,) * 4, 128,
                               head_align_corners=False, gated_skip=True,
                               non_negative=non_negative)
        if dtype == COMPUTE_DTYPE:
            cast_matmul_params_bf16(self.scratch)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.scratch(self.pretrained(images.to(self.dtype).float()))


@dataclasses.dataclass(frozen=True)
class MidasNetSmallConfig:
    """midas_v21_small: the tf_efficientnet_lite3 trunk tapped after stages
    1 / 2 / 4 / 6, expand-mode scratch (64 / 128 / 256 / 512), fusion blocks
    with out_conv."""

    backbone: Optional[EfficientNetConfig] = None
    features: int = 64
    image_size: int = 256

    def __post_init__(self):
        if self.backbone is None:
            object.__setattr__(self, "backbone", _lite3_encoder())


def _lite3_encoder() -> EfficientNetConfig:
    """tf_efficientnet_lite3: width 1.2 / depth 1.4, a fixed stem of 32,
    relu6, no SE, the first and last stages' depths unscaled."""
    return EfficientNetConfig(
        stem_channels=32,
        head_channels=1280,
        blocks=(
            BlockSpec("ds", 3, 1, 1, 16, 1),
            BlockSpec("ir", 3, 2, 6, 32, 3),
            BlockSpec("ir", 5, 2, 6, 48, 3),
            BlockSpec("ir", 3, 2, 6, 96, 5),
            BlockSpec("ir", 5, 1, 6, 136, 5),
            BlockSpec("ir", 5, 2, 6, 232, 6),
            BlockSpec("ir", 3, 1, 6, 384, 1),
        ),
        activation="relu6",
        use_se=False,
        include_head=False,
    )


def _tiny_lite_encoder() -> EfficientNetConfig:
    return EfficientNetConfig(
        stem_channels=8,
        head_channels=16,
        blocks=(
            BlockSpec("ds", 3, 1, 1, 4, 1),
            BlockSpec("ir", 3, 2, 2, 6, 1),
            BlockSpec("ir", 5, 2, 2, 8, 1),
            BlockSpec("ir", 3, 2, 2, 12, 1),
            BlockSpec("ir", 5, 1, 2, 16, 1),
            BlockSpec("ir", 5, 2, 2, 20, 1),
            BlockSpec("ir", 3, 1, 2, 24, 1),
        ),
        activation="relu6",
        use_se=False,
        include_head=False,
    )


class MidasNetSmall(nn.Module):
    """midas_v21_small: the EfficientNet trunk (fp32, its input rounded to
    `dtype`) regrouped as `pretrained.layer1` = stem + stages 0-1, `layer2`
    = stage 2, `layer3` = stages 3-4, `layer4` = stages 5-6; the expand-mode
    scratch. ImageNet-normalized NCHW in, (N, H, W) depth out."""

    def __init__(self, config: MidasNetSmallConfig, non_negative: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        self.dtype = dtype
        trunk = EfficientNetFeatures(cfg.backbone)
        b = trunk.blocks
        self.pretrained = Stages(
            nn.Sequential(trunk.conv_stem, trunk.bn1, trunk.act1, b[0], b[1]),
            nn.Sequential(b[2]), nn.Sequential(b[3], b[4]), nn.Sequential(b[5], b[6]))
        f = cfg.features
        self.scratch = Scratch(
            tuple(cfg.backbone.blocks[s].channels for s in (1, 2, 4, 6)), (f, 2 * f, 4 * f, 8 * f),
            (f, f, 2 * f, 4 * f), f // 2, head_align_corners=False, gated_skip=False,
            non_negative=non_negative)
        if dtype == COMPUTE_DTYPE:
            cast_matmul_params_bf16(self.scratch)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.scratch(self.pretrained(images.to(self.dtype).float()))


# -- the wrapper ---------------------------------------------------------------


def _model(name: str):
    """(module class, config, normalization mean, std) of a model name."""
    if name in ("midas_v21_small", "tiny_v21_small"):
        cfg = (MidasNetSmallConfig(backbone=_tiny_lite_encoder(), features=8, image_size=64)
               if name == "tiny_v21_small" else MidasNetSmallConfig())
        return MidasNetSmall, cfg, IMAGENET_MEAN, IMAGENET_STD
    if name in ("midas_v21", "tiny_v21"):
        cfg = (MidasNetConfig(backbone=TINY_RESNEXT, features=8, image_size=64)
               if name == "tiny_v21" else MidasNetConfig())
        return MidasNet, cfg, IMAGENET_MEAN, IMAGENET_STD
    return DPTDepthModel, CONFIGS[name], (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)


@cache
class MidasDepth:
    def __init__(self, name: str = "dpt_large", optimize: bool = True, device="cuda",
                 seed: Union[int, torch.Generator] = 0):
        """`name` is one of CHECKPOINT_NAMES or TEST_NAMES; `optimize`
        computes in bf16 where the JAX package does, else in fp32; the
        weights are those of the checkpoint `find_checkpoint("midas_<name>",
        name)` finds (`utils.checkpoints.load_found`), else random from
        `seed` (an int or a `torch.Generator` on `device`); `device` is CUDA unless the caller passes "cpu"."""
        if name not in CHECKPOINT_NAMES + TEST_NAMES:
            raise ValueError(f"midas_model_type '{name}' not implemented")
        self.name = name
        self.device = resolve_device(device)
        dtype = COMPUTE_DTYPE if optimize else torch.float32
        cls, self.config, mean, std = _model(name)
        self.image_size = (self.config.image_size, self.config.image_size)
        self.mean = torch.tensor(mean, device=self.device).reshape(1, 3, 1, 1)
        self.std = torch.tensor(std, device=self.device).reshape(1, 3, 1, 1)
        if not isinstance(seed, torch.Generator):
            seed = torch.Generator(device=self.device).manual_seed(seed)
        self.module = random_module(lambda cfg: cls(cfg, dtype=dtype), self.config, self.device,
                                    seed, torch.float32)
        path = find_checkpoint(f"midas_{name}", name)
        if path is not None:
            load_found(path, {"module": self.module}, self._from_jax, self.load_state_dict)

    def _from_jax(self, params) -> Dict[str, Dict[str, torch.Tensor]]:
        from perceptor_tpu_torch import convert

        to_state_dict = {
            DPTConfig: convert.dpt_state_dict_from_jax,
            MidasNetConfig: convert.midas_net_state_dict_from_jax,
            MidasNetSmallConfig: convert.midas_net_small_state_dict_from_jax,
        }[type(self.config)]
        return {"module": to_state_dict(params, self.config)}

    def load_state_dict(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """Load an upstream-named state_dict; the module keeps its storage
        dtypes."""
        self.module.load_state_dict(state_dict)

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        """images (N, 3, H, W) in [0, 1], resized to the model's
        `image_size` -> the NEGATED depth (N, 1, *image_size), fp32."""
        if tuple(images.shape[-2:]) != self.image_size:
            images = resize(images, out_shape=self.image_size)
        depth = self.module((images - self.mean) / self.std)
        return -depth[:, None]

    forward = __call__
