"""Real-ESRGAN super-resolution (counterpart of
perceptor_tpu/models/super_resolution.py), NCHW.

`RRDBNet` (basicsr's residual-in-residual dense trunk; pixel-unshuffle first
for scales 1 and 2, nearest x2 upsampling stages, a third for scale 8),
`SRVGGNetCompact` (a plain conv / PReLU body, pixel-shuffle and a nearest
base) and the spectral-norm `UNetDiscriminatorSN` keep basicsr's names, so
a basicsr state_dict loads as it is (its "params_ema" / "params" nesting is
read) and the JAX package's `convert_rrdbnet`, `convert_srvgg` and
`convert_unet_discriminator` read the port's. The discriminator holds plain
`conv{i}.weight`s: `convert_unet_discriminator` folds a basicsr file's
spectral norm, sigma = u^T W v once, with no power iteration.

`SuperResolution(name)` is the memoized wrapper: `upsample` the whole frame
(differentiable), or `enhance` the RealESRGANer way (a reflect pre-pad at the
bottom and right, the mod pad of scales 1 and 2, and optionally tiles: the
frame re-gridded to uniform tiles, reflect-padded to a whole grid, each run
in a fixed-size context window clamped inside the frame, as JAX's
`_tiled_apply` does). `half=True` stores the matmul weights in bf16.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from perceptor_tpu_torch.core.dtypes import COMPUTE_DTYPE, cast_matmul_params_bf16
from perceptor_tpu_torch.core.init import random_module, resolve_device
from perceptor_tpu_torch.ops.layers import Conv2d
from perceptor_tpu_torch.ops.resize import interpolate_bilinear, resize
from perceptor_tpu_torch.utils.cache import cache
from perceptor_tpu_torch.utils.checkpoints import find_checkpoint, load_found

CHECKPOINT_CONFIGS = {
    # name -> (arch, scale, num_block/num_conv)
    "x2": ("rrdb", 2, 23),
    "x4": ("rrdb", 4, 23),
    "x8": ("rrdb", 8, 23),
    "RealESRGAN_x4plus": ("rrdb", 4, 23),
    "RealESRNet_x4plus": ("rrdb", 4, 23),
    "RealESRGAN_x2plus": ("rrdb", 2, 23),
    "RealESRGAN_x4plus_anime_6B": ("rrdb", 4, 6),
    "RealESRGANv2-animevideo-xsx2": ("srvgg", 2, 16),
    "RealESRGANv2-animevideo-xsx4": ("srvgg", 4, 16),
    "tiny": ("rrdb", 2, 1),
}


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def pixel_unshuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(N, C, H, W) -> (N, C s^2, H/s, W/s), torch's channel order."""
    return F.pixel_unshuffle(x, scale)


def pixel_shuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(N, C s^2, H, W) -> (N, C, H s, W s), torch's channel order."""
    return F.pixel_shuffle(x, scale)


def _nearest_up(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def _conv3(in_channels: int, out_channels: int, bias: bool = True) -> Conv2d:
    return Conv2d(in_channels, out_channels, 3, padding=1, bias=bias)


class ResidualDenseBlock(nn.Module):
    def __init__(self, num_feat: int, num_grow_ch: int):
        super().__init__()
        for i in range(1, 6):
            out = num_feat if i == 5 else num_grow_ch
            setattr(self, f"conv{i}", _conv3(num_feat + (i - 1) * num_grow_ch, out))

    def forward(self, x):
        x1 = _lrelu(self.conv1(x))
        x2 = _lrelu(self.conv2(torch.cat([x, x1], 1)))
        x3 = _lrelu(self.conv3(torch.cat([x, x1, x2], 1)))
        x4 = _lrelu(self.conv4(torch.cat([x, x1, x2, x3], 1)))
        x5 = self.conv5(torch.cat([x, x1, x2, x3, x4], 1))
        return x5 * 0.2 + x


class RRDB(nn.Module):
    def __init__(self, num_feat: int, num_grow_ch: int):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb2 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb3 = ResidualDenseBlock(num_feat, num_grow_ch)

    def forward(self, x):
        return self.rdb3(self.rdb2(self.rdb1(x))) * 0.2 + x


@dataclasses.dataclass(frozen=True)
class RRDBConfig:
    scale: int = 4
    num_feat: int = 64
    num_block: int = 23
    num_grow_ch: int = 32
    out_channels: int = 3


class RRDBNet(nn.Module):
    """Scales 1 and 2 pixel-unshuffle the input by 4 and 2 first; every
    scale then upsamples twice by nearest x2 (scale 8 three times)."""

    def __init__(self, config: RRDBConfig):
        super().__init__()
        self.config = config
        nf = config.num_feat
        in_channels = 3 * {1: 16, 2: 4}.get(config.scale, 1)
        self.conv_first = _conv3(in_channels, nf)
        self.body = nn.ModuleList([RRDB(nf, config.num_grow_ch) for _ in range(config.num_block)])
        self.conv_body = _conv3(nf, nf)
        self.conv_up1 = _conv3(nf, nf)
        self.conv_up2 = _conv3(nf, nf)
        if config.scale == 8:
            self.conv_up3 = _conv3(nf, nf)
        self.conv_hr = _conv3(nf, nf)
        self.conv_last = _conv3(nf, config.out_channels)

    def forward(self, images):
        """images (N, 3, H, W) -> (N, 3, H s, W s), fp32."""
        x = images
        if self.config.scale in (1, 2):
            x = pixel_unshuffle(x, {1: 4, 2: 2}[self.config.scale])
        feat = self.conv_first(x)
        body = feat
        for block in self.body:
            body = block(body)
        feat = feat + self.conv_body(body)
        feat = _lrelu(self.conv_up1(_nearest_up(feat)))
        feat = _lrelu(self.conv_up2(_nearest_up(feat)))
        if self.config.scale == 8:
            feat = _lrelu(self.conv_up3(_nearest_up(feat)))
        return self.conv_last(_lrelu(self.conv_hr(feat))).float()


class PReLU(nn.PReLU):
    """Per-channel PReLU under JAX's promotion: a bf16 input against the
    fp32 slope gives an fp32 output."""

    def forward(self, x):
        return torch.where(x >= 0, x, x * self.weight[:, None, None])


@dataclasses.dataclass(frozen=True)
class SRVGGConfig:
    upscale: int = 4
    num_feat: int = 64
    num_conv: int = 16
    out_channels: int = 3


class SRVGGNetCompact(nn.Module):
    """basicsr's `body` list: conv, PReLU, then `num_conv` (conv, PReLU)
    pairs, then the conv to out_channels * upscale^2."""

    def __init__(self, config: SRVGGConfig):
        super().__init__()
        self.config = config
        nf = config.num_feat
        layers = [_conv3(3, nf), PReLU(nf)]
        for _ in range(config.num_conv):
            layers += [_conv3(nf, nf), PReLU(nf)]
        layers.append(_conv3(nf, config.out_channels * config.upscale**2))
        self.body = nn.ModuleList(layers)

    def forward(self, images):
        x = images.to(self.body[0].weight.dtype)
        h = x
        for layer in self.body:
            h = layer(h)
        out = pixel_shuffle(h, self.config.upscale) + _nearest_up(x, self.config.upscale)
        return out.float()


class UNetDiscriminatorSN(nn.Module):
    """basicsr's UNet discriminator with the spectral norm folded into the
    weights: NCHW images -> (N, 1, H, W) logits, fp32. The 4 x 4 stride-2
    convs pad 1 and, like the 3 x 3 ones between conv0 and conv9, have no
    bias; `up2` is a bilinear x2 with half-pixel centres."""

    def __init__(self, num_feat: int = 64, skip_connection: bool = True):
        super().__init__()
        nf = num_feat
        self.skip_connection = skip_connection
        self.conv0 = _conv3(3, nf)
        self.conv1 = Conv2d(nf, nf * 2, 4, 2, 1, bias=False)
        self.conv2 = Conv2d(nf * 2, nf * 4, 4, 2, 1, bias=False)
        self.conv3 = Conv2d(nf * 4, nf * 8, 4, 2, 1, bias=False)
        self.conv4 = _conv3(nf * 8, nf * 4, bias=False)
        self.conv5 = _conv3(nf * 4, nf * 2, bias=False)
        self.conv6 = _conv3(nf * 2, nf, bias=False)
        self.conv7 = _conv3(nf, nf, bias=False)
        self.conv8 = _conv3(nf, nf, bias=False)
        self.conv9 = _conv3(nf, 1)

    @staticmethod
    def _up2(h):
        return interpolate_bilinear(h, (h.shape[-2] * 2, h.shape[-1] * 2), align_corners=False)

    def forward(self, images):
        x0 = _lrelu(self.conv0(images))
        x1 = _lrelu(self.conv1(x0))
        x2 = _lrelu(self.conv2(x1))
        x3 = _lrelu(self.conv3(x2))
        x4 = _lrelu(self.conv4(self._up2(x3)))
        if self.skip_connection:
            x4 = x4 + x2
        x5 = _lrelu(self.conv5(self._up2(x4)))
        if self.skip_connection:
            x5 = x5 + x1
        x6 = _lrelu(self.conv6(self._up2(x5)))
        if self.skip_connection:
            x6 = x6 + x0
        out = _lrelu(self.conv8(_lrelu(self.conv7(x6))))
        return self.conv9(out).float()


def _unwrap(state_dict: Mapping) -> Mapping:
    """basicsr nests its weights under "params_ema" or "params"."""
    return state_dict.get("params_ema") or state_dict.get("params") or state_dict


def convert_unet_discriminator(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """A basicsr `UNetDiscriminatorSN` state_dict -> the port's: each
    spectral-normed conv's `weight_orig` divided by sigma = u^T W v (W the
    weight flattened to (out, -1)), the plain convs and biases as they are."""
    sd = _unwrap(state_dict)
    out: Dict[str, torch.Tensor] = {}
    for i in range(10):
        name = f"conv{i}"
        if f"{name}.weight" in sd:
            out[f"{name}.weight"] = torch.as_tensor(sd[f"{name}.weight"])
        elif f"{name}.weight_orig" in sd:
            w = torch.as_tensor(sd[f"{name}.weight_orig"]).float()
            u = torch.as_tensor(sd[f"{name}.weight_u"]).float()
            v = torch.as_tensor(sd[f"{name}.weight_v"]).float()
            out[f"{name}.weight"] = w / (u @ w.reshape(w.shape[0], -1) @ v)
        if f"{name}.bias" in sd:
            out[f"{name}.bias"] = torch.as_tensor(sd[f"{name}.bias"])
    return out


def _reflect_indices(size: int, pad: int, device) -> torch.Tensor:
    """Indices of a numpy-style reflect pad of `pad` after a dim of `size`
    (the edge not repeated; a pad longer than the dim reflects again)."""
    idx = np.arange(size + pad)
    if size > 1:
        period = 2 * (size - 1)
        idx = idx % period
        idx = np.where(idx >= size, period - idx, idx)
    else:
        idx = np.zeros_like(idx)
    return torch.as_tensor(idx, device=device)


def _reflect_pad_end(x: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """jnp.pad(x, ((0, 0), (0, 0), (0, pad_h), (0, pad_w)), mode="reflect")."""
    if pad_h:
        x = x.index_select(-2, _reflect_indices(x.shape[-2], pad_h, x.device))
    if pad_w:
        x = x.index_select(-1, _reflect_indices(x.shape[-1], pad_w, x.device))
    return x


@cache
class SuperResolution:
    def __init__(
        self,
        name: str = "x4",
        half: bool = True,
        device="cuda",
        seed: Union[int, torch.Generator] = 0,
    ):
        """The Real-ESRGAN network `name` (CHECKPOINT_CONFIGS), frozen on
        `device` (CUDA unless the caller passes "cpu") with the weights of
        the checkpoint `find_checkpoint("super_resolution_<name>", name)`
        finds, else random from `seed`, its matmul weights in bf16 with
        `half`; memoized on its arguments. `load_state_dict` takes a basicsr
        file."""
        if name not in CHECKPOINT_CONFIGS:
            raise ValueError(f"unknown super resolution model: {name}")
        self.name = name
        arch, scale, blocks = CHECKPOINT_CONFIGS[name]
        self.scale = scale
        self.device = resolve_device(device)
        self.dtype = COMPUTE_DTYPE if half else torch.float32
        if arch == "rrdb":
            tiny = name == "tiny"
            config = RRDBConfig(scale=scale, num_feat=8 if tiny else 64, num_block=blocks,
                                num_grow_ch=8 if tiny else 32)
            cls = RRDBNet
        else:
            config, cls = SRVGGConfig(upscale=scale, num_conv=blocks), SRVGGNetCompact
        generator = seed if isinstance(seed, torch.Generator) else torch.Generator(
            device=self.device).manual_seed(seed)
        self.module = random_module(cls, config, self.device, generator, self.dtype)
        with torch.no_grad():
            for layer in self.module.modules():
                if isinstance(layer, PReLU):
                    layer.weight.fill_(0.25)  # nn.PReLU's init: a unit slope is no activation
        self._config = config
        path = find_checkpoint(f"super_resolution_{name}", name)
        if path is not None:
            load_found(path, {"module": self.module}, self._from_jax, self.load_state_dict)

    def _from_jax(self, params) -> Dict[str, Dict[str, torch.Tensor]]:
        from perceptor_tpu_torch import convert

        if isinstance(self._config, RRDBConfig):
            return {"module": convert.rrdbnet_state_dict_from_jax(params)}
        return {"module": convert.srvgg_state_dict_from_jax(params, self._config.num_conv)}

    def load_state_dict(self, state_dict: Mapping) -> None:
        self.module.load_state_dict(_unwrap(state_dict))
        if self.dtype == COMPUTE_DTYPE:
            cast_matmul_params_bf16(self.module)

    def upsample(self, images: torch.Tensor) -> torch.Tensor:
        """Full-frame differentiable upsample, (N, 3, H, W) -> (N, 3, H s,
        W s), fp32."""
        return self.module(images)

    __call__ = upsample
    forward = upsample

    def enhance(self, images: torch.Tensor, tile_size: int = 0, tile_pad: int = 10,
                pre_pad: int = 10) -> torch.Tensor:
        """RealESRGANer's enhance: the reflect pre-pad, the mod pad of scales
        1 and 2, the whole frame or (`tile_size` > 0) uniform tiles, then the
        crop to (H s, W s). Differentiable."""
        scale = self.scale
        h_in, w_in = images.shape[-2:]
        x = _reflect_pad_end(images, pre_pad, pre_pad)
        mod = {1: 4, 2: 2}.get(scale)
        if mod is not None:
            x = _reflect_pad_end(x, -x.shape[-2] % mod, -x.shape[-1] % mod)
        out = self.module(x) if tile_size <= 0 else self._tiled_apply(x, tile_size, tile_pad)
        return out[..., : h_in * scale, : w_in * scale]

    def _tiled_apply(self, x: torch.Tensor, tile_size: int, tile_pad: int) -> torch.Tensor:
        """The frame reflect-padded to whole tiles; each tile upsampled in a
        window of tile_size + 2 tile_pad clamped inside the frame, its
        centre kept."""
        scale = self.scale
        h0, w0 = x.shape[-2:]
        x = _reflect_pad_end(x, -h0 % tile_size, -w0 % tile_size)
        h, w = x.shape[-2:]
        win_h, win_w = min(tile_size + 2 * tile_pad, h), min(tile_size + 2 * tile_pad, w)
        rows = []
        for ofs_y in range(0, h, tile_size):
            sy = min(max(ofs_y - tile_pad, 0), h - win_h)
            row = []
            for ofs_x in range(0, w, tile_size):
                sx = min(max(ofs_x - tile_pad, 0), w - win_w)
                up = self.module(x[..., sy: sy + win_h, sx: sx + win_w])
                cy, cx = (ofs_y - sy) * scale, (ofs_x - sx) * scale
                row.append(up[..., cy: cy + tile_size * scale, cx: cx + tile_size * scale])
            rows.append(torch.cat(row, dim=-1))
        return torch.cat(rows, dim=-2)[..., : h0 * scale, : w0 * scale]

    def downsample(self, upsampled_images: torch.Tensor, size: Optional[tuple] = None):
        if size is None:
            size = [s // self.scale for s in upsampled_images.shape[-2:]]
        return resize(upsampled_images, out_shape=size)
