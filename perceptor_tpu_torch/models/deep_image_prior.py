"""Deep image prior: the HQ skip network (counterpart of
perceptor_tpu/models/deep_image_prior.py), NCHW.

`SkipNet` is the reference's `get_hq_skip_net`: per level a 1x1 skip
branch of width 4 and a deeper branch (3x3 conv, cubic FIR downsampling,
conv), the next level, cubic FIR upsampling, then the concatenation
decoded by a 3x3 and a 1x1 conv; LeakyReLU 0.2 throughout; 3x3 convs pad by
reflection; a 1x1 head, the colour-decorrelation matrix in fp32 and a
sigmoid. BatchNorm (`TrainBatchNorm`) always uses the batch statistics over
(N, H, W), in fp32, with the biased variance and eps 1e-5. Under
`offset_type` "1x1" or "full" each 3x3 conv is a `DeformConvLayer`: its
offsets come from a conv in the compute dtype (so they are rounded to bf16
before `ops.deform_conv2d` takes them to fp32), and the offset-group count
is lowered until it divides the input channels.

Module names are the JAX module's flax names (`skip_{i}_conv`,
`down_{i}_conv1`, `up_{i}_bn0`, `head_conv`, each deformable conv's
`offset_conv`), so `convert.deep_image_prior_state_dict_from_jax` is a
plain walk. `fp16=True` stores the convs' weights in bf16 (bf16 compute)
while BatchNorm and the head's decorrelation run in fp32.

`DeepImagePrior` holds a trainable `SkipNet` with seeded random weights;
it is not memoized, since an optimizer updates its weights in place. Its
`optimizer(lr)` is `run_on_device`'s factory `params -> torch.optim.Adam`
with the offset branches at lr / 10 (the JAX package's
`optax.multi_transform` over `offset_param_labels`).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from perceptor_tpu_torch.core.dtypes import COMPUTE_DTYPE, cast_matmul_params_bf16
from perceptor_tpu_torch.core.init import init_random_, resolve_device
from perceptor_tpu_torch.ops.deform_conv import deform_conv2d
from perceptor_tpu_torch.ops.layers import Conv2d
from perceptor_tpu_torch.ops.upfirdn import fir_downsample_2x, fir_upsample_2x

DEFAULT_SIZE = 256
DEFAULT_SHAPE = (128, DEFAULT_SIZE, DEFAULT_SIZE)
OFFSET_TYPES = ("none", "1x1", "full")
OFFSET_LR_FACTOR = 0.1

# aphantasia's colour-correlation matrix (reference common.py:106-129)
_COLOR_CORR = np.array(
    [[0.26, 0.09, 0.02], [0.27, 0.00, -0.05], [0.27, -0.09, 0.03]], dtype=np.float32
)


def _decorrelation_matrix(inv_color_scale: float = 1.6) -> np.ndarray:
    m = _COLOR_CORR / np.array([inv_color_scale, 1.0, 1.0], dtype=np.float32)
    m = m / np.linalg.norm(m, axis=0).max()
    return m.T


class TrainBatchNorm(nn.Module):
    """BatchNorm on the batch statistics (the only mode DIP runs in): fp32
    statistics with the biased variance, the output in the input's dtype."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3), keepdim=True)
        var = xf.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight[:, None, None] + self.bias[:, None, None]).to(x.dtype)


class ReflectConv2d(Conv2d):
    """A k x k conv over the input padded by (k - 1) / 2 by reflection."""

    def forward(self, x):
        pad = (self.kernel_size[0] - 1) // 2
        return super().forward(F.pad(x, (pad,) * 4, mode="reflect") if pad else x)


class DeformConvLayer(nn.Module):
    """Reflection-padded deformable conv (reference common.py:163-219):
    offsets from a 1x1 conv on the input ("1x1") or a k x k conv on the
    padded input ("full")."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 offset_groups: int = 4, offset_type: str = "1x1"):
        super().__init__()
        if offset_type not in ("1x1", "full"):
            raise ValueError(f"unknown offset_type {offset_type!r}")
        groups = offset_groups
        while groups > 1 and in_channels % groups:
            groups -= 1
        self.kernel, self.offset_type = kernel, offset_type
        self.offset_conv = Conv2d(in_channels, 2 * groups * kernel * kernel,
                                  1 if offset_type == "1x1" else kernel)
        self.weight = nn.Parameter(torch.empty(features, in_channels, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        pad = (self.kernel - 1) // 2
        x_pad = F.pad(x, (pad,) * 4, mode="reflect")
        offsets = self.offset_conv(x if self.offset_type == "1x1" else x_pad)
        return deform_conv2d(x_pad.to(self.weight.dtype), offsets, self.weight, self.bias)


class SkipNet(nn.Module):
    """The HQ skip encoder-decoder (reference skip.py:7-167), NCHW."""

    def __init__(
        self,
        input_channels: int,
        output_channels: int = 3,
        n_scales: int = 2,
        channels_down: int = 192,
        channels_up: int = 192,
        channels_skip: int = 4,
        sigmoid: bool = True,
        decorrelate_rgb: bool = True,
        offset_type: str = "none",
        offset_groups: int = 4,
    ):
        super().__init__()
        if offset_type not in OFFSET_TYPES:
            raise ValueError(f"unknown offset_type {offset_type!r}")
        self.n_scales, self.sigmoid = n_scales, sigmoid
        self.decorrelate = decorrelate_rgb and output_channels == 3

        def conv3(name, c_in, c_out):
            if offset_type == "none":
                self.add_module(name, ReflectConv2d(c_in, c_out, 3))
            else:
                self.add_module(name, DeformConvLayer(c_in, c_out, 3, offset_groups, offset_type))

        for i in range(n_scales):
            c_in = input_channels if i == 0 else channels_down
            deeper = channels_up if i < n_scales - 1 else channels_down
            self.add_module(f"skip_{i}_conv", Conv2d(c_in, channels_skip, 1))
            self.add_module(f"skip_{i}_bn", TrainBatchNorm(channels_skip))
            conv3(f"down_{i}_conv1", c_in, channels_down)
            self.add_module(f"down_{i}_bn1", TrainBatchNorm(channels_down))
            conv3(f"down_{i}_conv2", channels_down, channels_down)
            self.add_module(f"down_{i}_bn2", TrainBatchNorm(channels_down))
            self.add_module(f"up_{i}_bn0", TrainBatchNorm(channels_skip + deeper))
            conv3(f"up_{i}_conv1", channels_skip + deeper, channels_up)
            self.add_module(f"up_{i}_bn1", TrainBatchNorm(channels_up))
            self.add_module(f"up_{i}_conv2", Conv2d(channels_up, channels_up, 1))
            self.add_module(f"up_{i}_bn2", TrainBatchNorm(channels_up))
        self.head_conv = Conv2d(channels_up, output_channels, 1)
        self.register_buffer("decorrelation", torch.empty(3, 3), persistent=False)
        self.reset_buffers()

    def reset_buffers(self) -> None:
        """The fixed decorrelation matrix (`core/init.py init_random_` calls
        this after a meta-device build)."""
        if not self.decorrelation.is_meta:
            self.decorrelation.copy_(torch.from_numpy(_decorrelation_matrix()))

    def _level(self, i: int, x):
        def run(name, h):
            return getattr(self, name.format(i))(h)

        def act(h):
            return F.leaky_relu(h, 0.2)

        s = act(run("skip_{}_bn", run("skip_{}_conv", x)))
        h = fir_downsample_2x(run("down_{}_conv1", x), kernel="cubic")
        h = act(run("down_{}_bn1", h))
        h = act(run("down_{}_bn2", run("down_{}_conv2", h)))
        if i < self.n_scales - 1:
            h = self._level(i + 1, h)
        h = fir_upsample_2x(h, kernel="cubic")
        y = run("up_{}_bn0", torch.cat([s, h], dim=1))
        y = act(run("up_{}_bn1", run("up_{}_conv1", y)))
        return act(run("up_{}_bn2", run("up_{}_conv2", y)))

    def forward(self, latents):
        """latents (N, C, H, W) -> images (N, output_channels, H, W) fp32."""
        x = self._level(0, latents.to(self.head_conv.weight.dtype))
        x = self.head_conv(x).float()
        if self.decorrelate:
            x = torch.einsum("nchw,cd->ndhw", x, self.decorrelation)
        return torch.sigmoid(x) if self.sigmoid else x


def offset_param_labels(named_parameters: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, str]:
    """{name: "offset" or "main"} over `named_parameters` (a module's
    `named_parameters()`): "offset" where the name holds `offset_conv`, the
    reference's offset / non-offset split (get_hq_skip_net.py:128, :140)."""
    return {name: "offset" if "offset_conv" in name else "main"
            for name, _ in named_parameters}


def offset_adam(labels: Sequence[str], learning_rate: float = 0.01
                ) -> Callable[[Sequence[torch.Tensor]], torch.optim.Adam]:
    """`run_on_device`'s optimizer factory: Adam over params given in the
    order of `labels`, those labelled "offset" at lr * OFFSET_LR_FACTOR."""
    labels = list(labels)

    def factory(params):
        params = list(params)
        if len(params) != len(labels):
            raise ValueError(f"expected {len(labels)} parameter tensors, got {len(params)}")
        groups = [
            {"params": [p for p, lab in zip(params, labels) if lab == label], "lr": lr}
            for label, lr in (("main", learning_rate),
                              ("offset", learning_rate * OFFSET_LR_FACTOR))
        ]
        return torch.optim.Adam([g for g in groups if g["params"]])

    return factory


class DeepImagePrior(nn.Module):
    """The skip net on `device` with seeded random weights (reference
    deep_image_prior.py:17-151); trainable."""

    def __init__(
        self,
        shape: Tuple[int, int, int] = DEFAULT_SHAPE,
        offset_type: str = "none",
        n_scales: int = 2,
        sigmoid: bool = True,
        decorrelate_rgb: bool = True,
        output_channels: int = 3,
        seed: int = 0,
        fp16: bool = True,
        device="cuda",
    ):
        """`fp16=True` computes the convs in bf16 with fp32 BatchNorm and
        head."""
        super().__init__()
        if offset_type not in OFFSET_TYPES:
            raise ValueError(f"unknown offset_type {offset_type!r}")
        input_channels, height, width = shape
        if height != width or height % 8:
            raise ValueError("DIP expects square size divisible by 8")
        self.shape = tuple(shape)
        self.n_scales = n_scales
        self.output_channels = output_channels
        self.device = resolve_device(device)
        with torch.device("meta"):
            module = SkipNet(input_channels, output_channels, n_scales, sigmoid=sigmoid,
                             decorrelate_rgb=decorrelate_rgb, offset_type=offset_type)
        self.module = module.to_empty(device=self.device)
        init_random_(self.module, torch.Generator(device=self.device).manual_seed(seed))
        if fp16:
            cast_matmul_params_bf16(self.module)
        self.dtype = COMPUTE_DTYPE if fp16 else torch.float32

    @property
    def input_channels(self):
        return self.shape[0]

    @property
    def height(self):
        return self.shape[1]

    @property
    def width(self):
        return self.shape[2]

    def forward(self, latents, params=None):
        """The net on `latents`, at its own weights or at `params` (tensors
        in the order of `module.parameters()`)."""
        if params is None:
            return self.module(latents)
        return self.apply_fn(params, latents)

    def apply_fn(self, params, latents):
        names = [name for name, _ in self.module.named_parameters()]
        return torch.func.functional_call(self.module, dict(zip(names, params)), (latents,))

    # -- latent factories (reference :73-133) ----------------------------------

    def random_latents(self, generator: torch.Generator, size: int = 1,
                       n_channels: Optional[int] = None) -> torch.Tensor:
        n_channels = n_channels or self.input_channels
        return 0.1 * torch.randn((size, n_channels, self.height, self.width),
                                 generator=generator, device=self.device)

    def fourier_latents(self, size: int = 1, n_channels: Optional[int] = None,
                        min_log2_frequency: float = 0.0, max_log2_frequency: float = 9.0,
                        log2_space: bool = False) -> torch.Tensor:
        n_channels = n_channels or self.input_channels
        if n_channels % 4:
            raise ValueError("n_channels must be divisible by 4")
        xs = np.linspace(-1, 1, self.width)
        ys = np.linspace(-1, 1, self.height)
        meshgrid = np.stack(np.meshgrid(xs, ys, indexing="ij"), axis=0)
        if log2_space:
            frequencies = 2.0 ** np.linspace(min_log2_frequency, max_log2_frequency,
                                             n_channels // 4)
        else:
            frequencies = np.linspace(2.0**min_log2_frequency, 2.0**max_log2_frequency,
                                      n_channels // 4)
        phases = meshgrid[None] * frequencies[:, None, None, None] * 2 * np.pi
        latents = np.concatenate([np.sin(phases), np.cos(phases)], axis=0)
        latents = latents.reshape(1, -1, self.height, self.width)
        latents = np.repeat(latents, size, axis=0) * 0.3
        return torch.as_tensor(latents.astype(np.float32), device=self.device)

    def noisy_image_latents(self, images, generator: torch.Generator,
                            n_channels: Optional[int] = None,
                            log_snr: float = -1.0) -> torch.Tensor:
        n_channels = n_channels or self.input_channels
        sigma = 1.0 / (np.sqrt(np.exp(log_snr)) + 1.0)
        channels = images.shape[1]
        repeated = torch.stack([images[:, index % channels] for index in range(n_channels)],
                               dim=1)
        noise = torch.randn(repeated.shape, generator=generator, device=repeated.device,
                            dtype=repeated.dtype)
        return 0.1 * ((repeated * 2 - 1) * (1 - sigma) + noise * sigma)

    # -- the offset branches' learning rate (reference get_hq_skip_net.py:120-140,
    #    deep_image_prior.py:135-151) ------------------------------------------

    def offset_param_labels(self) -> Dict[str, str]:
        return offset_param_labels(self.module.named_parameters())

    def optimizer(self, learning_rate: float = 0.01):
        """Adam over the net's parameters with the offset branches at lr / 10,
        as `run_on_device` takes it."""
        return offset_adam(self.offset_param_labels().values(), learning_rate)
