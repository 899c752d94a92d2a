"""StyleGAN-XL's alias-free (StyleGAN3) generator (counterpart of
perceptor_tpu/models/stylegan_xl.py), NCHW.

The modules carry the upstream `networks_stylegan3_resetting` names
(`mapping.embed`, `mapping.embed_proj`, `mapping.fc{i}`, `mapping.w_avg`,
`synthesis.input.{weight, affine, transform, freqs, phases}`,
`synthesis.L{idx}_{size}_{channels}.{affine, weight, bias, magnitude_ema,
up_filter, down_filter}`), so a snapshot's generator state_dict loads
through `convert_stylegan_xl` with `strict=True`, and the JAX package's
`convert_stylegan_xl` reads the port's `state_dict()`. The low-pass filters
are designed on the host at construction (scipy), as JAX designs them.

Parameters stay fp32; `synthesis` casts at JAX's points: the input
features in fp32, then each layer's activations, conv weight and styles in
the compute dtype (so demodulation runs in bf16), the modulated weight
times `input_gain` widened to fp32 (JAX promotes against the 0-d fp32
gain) and rounded back, the to-RGB styles scaled in fp32 before the cast,
the bias in the compute dtype, and the output widened to fp32. The
mapping runs in fp32. `StyleGANXL(name)` is the memoized wrapper: w
latents -> images in [0, 1], `latents(...)` from numpy-seeded z.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from perceptor_tpu_torch.core.init import resolve_device
from perceptor_tpu_torch.ops.bias_act import bias_act
from perceptor_tpu_torch.ops.filtered_lrelu import filtered_lrelu
from perceptor_tpu_torch.utils.cache import cache
from perceptor_tpu_torch.utils.checkpoints import find_checkpoint, load_found


@dataclasses.dataclass(frozen=True)
class SynthesisConfig:
    w_dim: int = 512
    img_resolution: int = 128
    img_channels: int = 3
    channel_base: int = 32768
    channel_max: int = 512
    num_layers: int = 14
    num_critical: int = 2
    first_cutoff: float = 2.0
    first_stopband: float = 2**2.1
    last_stopband_rel: float = 2**0.3
    margin_size: int = 10
    output_scale: float = 0.25
    conv_kernel: int = 3
    filter_size: int = 6
    lrelu_upsampling: int = 2
    use_radial_filters: bool = False
    conv_clamp: float = 256.0

    @property
    def num_ws(self) -> int:
        return self.num_layers + 2


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    z_dim: int = 64
    c_dim: int = 1000
    w_dim: int = 512
    embed_dim: int = 320  # tf_efficientnet_lite0's feature width
    mapping_layers: int = 2
    synthesis: SynthesisConfig = SynthesisConfig()


TINY = GeneratorConfig(
    z_dim=8, c_dim=4, w_dim=16, embed_dim=8,
    synthesis=SynthesisConfig(
        w_dim=16, img_resolution=32, channel_base=512, channel_max=32,
        num_layers=6, margin_size=2,
    ),
)

MODEL_CONFIGS = {
    "imagenet128": GeneratorConfig(synthesis=SynthesisConfig(img_resolution=128)),
    "ffhq256": GeneratorConfig(c_dim=0, synthesis=SynthesisConfig(img_resolution=256)),
    "pokemon256": GeneratorConfig(synthesis=SynthesisConfig(img_resolution=256)),
    "tiny": TINY,
}


def design_lowpass_filter(numtaps, cutoff, width, fs, radial=False):
    """Kaiser-windowed low-pass taps (`scipy.signal.firwin`), or a radially
    symmetric jinc under a Kaiser window; None for a single tap."""
    import scipy.signal

    if numtaps == 1:
        return None
    if not radial:
        f = scipy.signal.firwin(numtaps=numtaps, cutoff=cutoff, width=width, fs=fs)
        return f.astype(np.float32)
    import scipy.special

    x = (np.arange(numtaps) - (numtaps - 1) / 2) / fs
    r = np.hypot(*np.meshgrid(x, x))
    f = scipy.special.j1(2 * cutoff * (np.pi * r)) / (np.pi * r)
    beta = scipy.signal.kaiser_beta(scipy.signal.kaiser_atten(numtaps, width / (fs / 2)))
    w = np.kaiser(numtaps, beta)
    f *= np.outer(w, w)
    f /= np.sum(f)
    return f.astype(np.float32)


def layer_specs(cfg: SynthesisConfig):
    """Per layer (and the input): cutoffs, stopbands, sampling rates, filter
    half-widths, sizes and channels, on the geometric progression of the
    reference's `SynthesisNetwork`."""
    last_cutoff = cfg.img_resolution / 2
    last_stopband = last_cutoff * cfg.last_stopband_rel
    exponents = np.minimum(np.arange(cfg.num_layers + 1) / (cfg.num_layers - cfg.num_critical), 1)
    cutoffs = cfg.first_cutoff * (last_cutoff / cfg.first_cutoff) ** exponents
    stopbands = cfg.first_stopband * (last_stopband / cfg.first_stopband) ** exponents
    sampling_rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, cfg.img_resolution))))
    half_widths = np.maximum(stopbands, sampling_rates / 2) - cutoffs
    sizes = sampling_rates + cfg.margin_size * 2
    sizes[-2:] = cfg.img_resolution
    channels = np.rint(np.minimum((cfg.channel_base / 2) / cutoffs, cfg.channel_max))
    channels[-1] = cfg.img_channels
    return cutoffs, stopbands, sampling_rates, half_widths, sizes, channels


def design_layers(cfg: SynthesisConfig) -> List[dict]:
    """Each synthesis layer's static design: name, channels, kernel, up and
    down factors, filters and the (x0, x1, y0, y1) padding."""
    cutoffs, _, sampling_rates, half_widths, sizes, channels = layer_specs(cfg)
    layers = []
    for idx in range(cfg.num_layers + 1):
        prev = max(idx - 1, 0)
        is_torgb = idx == cfg.num_layers
        is_critical = idx >= cfg.num_layers - cfg.num_critical
        tmp_rate = max(sampling_rates[prev], sampling_rates[idx]) * (
            1 if is_torgb else cfg.lrelu_upsampling)
        up_factor = int(np.rint(tmp_rate / sampling_rates[prev]))
        down_factor = int(np.rint(tmp_rate / sampling_rates[idx]))
        up_taps = cfg.filter_size * up_factor if (up_factor > 1 and not is_torgb) else 1
        down_taps = cfg.filter_size * down_factor if (down_factor > 1 and not is_torgb) else 1
        up_filter = design_lowpass_filter(up_taps, cutoffs[prev], half_widths[prev] * 2, tmp_rate)
        down_filter = design_lowpass_filter(
            down_taps, cutoffs[idx], half_widths[idx] * 2, tmp_rate,
            radial=cfg.use_radial_filters and not is_critical)
        in_size = np.broadcast_to(np.asarray(int(sizes[prev])), [2])
        out_size = np.broadcast_to(np.asarray(int(sizes[idx])), [2])
        conv_kernel = 1 if is_torgb else cfg.conv_kernel
        pad_total = (out_size - 1) * down_factor + 1
        pad_total = pad_total - (in_size + conv_kernel - 1) * up_factor
        pad_total = pad_total + up_taps + down_taps - 2
        pad_lo = (pad_total + up_factor) // 2
        pad_hi = pad_total - pad_lo
        layers.append(dict(
            name=f"L{idx}_{int(out_size[0])}_{int(channels[idx])}",
            is_torgb=is_torgb,
            in_channels=int(channels[prev]),
            out_channels=int(channels[idx]),
            conv_kernel=conv_kernel,
            up_factor=up_factor,
            down_factor=down_factor,
            up_filter=up_filter,
            down_filter=down_filter,
            padding=(int(pad_lo[0]), int(pad_hi[0]), int(pad_lo[1]), int(pad_hi[1])),
        ))
    return layers


class FullyConnectedLayer(nn.Module):
    """x @ (weight * lr_multiplier / sqrt(in))^T + bias * lr_multiplier,
    then the activation, in fp32; weight (out, in)."""

    def __init__(self, in_features: int, out_features: int, activation: str = "linear",
                 lr_multiplier: float = 1.0):
        super().__init__()
        self.activation = activation
        self.lr_multiplier = lr_multiplier
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = self.weight * (self.lr_multiplier / math.sqrt(self.weight.shape[1]))
        x = x @ weight.T
        b = self.bias * self.lr_multiplier
        if self.activation == "linear":
            return x + b
        return bias_act(x, b, dim=-1, act=self.activation)


def _normalize_2nd_moment(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=1, keepdim=True) + 1e-8)


class MappingNetwork(nn.Module):
    """z (and a class) -> w, tiled to `num_ws`: the normalized z, with a
    conditional generator the class embedding through `embed_proj`,
    normalized and concatenated; `mapping_layers` lrelu layers at
    lr_multiplier 0.01; truncation toward `w_avg` (per class)."""

    def __init__(self, config: GeneratorConfig):
        super().__init__()
        self.config = config
        if config.c_dim:
            self.embed = nn.Embedding(config.c_dim, config.embed_dim)
            self.embed_proj = FullyConnectedLayer(config.embed_dim, config.z_dim, activation="lrelu")
        features = [config.z_dim * (2 if config.c_dim else 1)] + [config.w_dim] * config.mapping_layers
        for idx in range(config.mapping_layers):
            setattr(self, f"fc{idx}", FullyConnectedLayer(
                features[idx], features[idx + 1], activation="lrelu", lr_multiplier=0.01))
        self.register_buffer("w_avg", torch.zeros(
            (config.c_dim, config.w_dim) if config.c_dim else (config.w_dim,)))

    def forward(self, z: torch.Tensor, class_indices=None, truncation_psi: float = 1.0):
        cfg = self.config
        x = _normalize_2nd_moment(z)
        if cfg.c_dim:
            if class_indices is None:
                raise ValueError("class-conditional generator needs class_indices")
            classes = torch.as_tensor(class_indices, dtype=torch.long, device=z.device)
            y = _normalize_2nd_moment(self.embed_proj(self.embed.weight[classes]))
            x = torch.cat([x, y], dim=1)
        for idx in range(cfg.mapping_layers):
            x = getattr(self, f"fc{idx}")(x)
        if truncation_psi != 1.0:
            w_avg = self.w_avg[classes] if cfg.c_dim else self.w_avg[None]
            x = w_avg + truncation_psi * (x - w_avg)
        return x[:, None].repeat(1, cfg.synthesis.num_ws, 1)


@functools.lru_cache(maxsize=64)
def _input_grid(size: int, sampling_rate: float, device: torch.device) -> torch.Tensor:
    """affine_grid(align_corners=False)'s pixel centers over [size, size],
    scaled by size / (2 sampling_rate): (H, W, 2) fp32 on `device`, built
    once per key."""
    theta = 0.5 * size / sampling_rate
    coords = (np.arange(size) * 2 + 1) / size - 1
    gx = np.broadcast_to(coords[None, :] * theta, (size, size))
    gy = np.broadcast_to(coords[:, None] * theta, (size, size))
    grid = np.stack([gx, gy], axis=-1).astype(np.float32)
    return torch.as_tensor(grid, device=device)


class SynthesisInput(nn.Module):
    """Fourier features under a w-dependent rotation and translation, faded
    out above the band, through a 1 / sqrt(C) linear map; fp32."""

    def __init__(self, w_dim: int, channels: int, size: int, sampling_rate: float,
                 bandwidth: float):
        super().__init__()
        self.channels, self.size = channels, size
        self.sampling_rate, self.bandwidth = float(sampling_rate), float(bandwidth)
        self.weight = nn.Parameter(torch.empty(channels, channels))
        self.affine = FullyConnectedLayer(w_dim, 4)
        self.register_buffer("transform", torch.eye(3))
        self.register_buffer("freqs", torch.zeros(channels, 2))
        self.register_buffer("phases", torch.zeros(channels))

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        t = self.affine(w)  # (N, 4)
        t = t / torch.linalg.vector_norm(t[:, :2], dim=1, keepdim=True)
        zero, one = torch.zeros_like(t[:, 0]), torch.ones_like(t[:, 0])
        m_r = torch.stack([torch.stack([t[:, 0], -t[:, 1], zero], -1),
                           torch.stack([t[:, 1], t[:, 0], zero], -1),
                           torch.stack([zero, zero, one], -1)], 1)
        m_t = torch.stack([torch.stack([one, zero, -t[:, 2]], -1),
                           torch.stack([zero, one, -t[:, 3]], -1),
                           torch.stack([zero, zero, one], -1)], 1)
        transforms = m_r @ m_t @ self.transform[None]
        freqs = self.freqs[None]  # (1, C, 2)
        phases = self.phases[None] + (freqs @ transforms[:, :2, 2:])[..., 0]
        freqs = freqs @ transforms[:, :2, :2]
        amplitudes = torch.clamp(
            1 - (torch.linalg.vector_norm(freqs, dim=2) - self.bandwidth)
            / (self.sampling_rate / 2 - self.bandwidth), 0, 1)
        grid = _input_grid(self.size, self.sampling_rate, w.device)
        x = torch.einsum("hwd,ncd->nhwc", grid, freqs) + phases[:, None, None, :]
        x = torch.sin(x * (np.pi * 2)) * amplitudes[:, None, None, :]
        x = x @ (self.weight / np.sqrt(self.channels)).T
        return x.permute(0, 3, 1, 2)


def _mean_square(x: torch.Tensor, dims, keepdim: bool = False) -> torch.Tensor:
    """mean(x^2): the square in x's dtype, the mean in fp32, the result back
    in x's dtype (jnp.mean's upcast of bf16)."""
    return x.square().float().mean(dim=dims, keepdim=keepdim).to(x.dtype)


def modulated_conv2d(x, weight, styles, padding=0, demodulate=True, input_gain=None):
    """x (N, I, H, W), weight (O, I, kh, kw), styles (N, I): per-sample
    modulated (and demodulated) weights, applied as one convolution with
    the batch as groups."""
    batch, in_channels = x.shape[:2]
    out_channels, _, kh, kw = weight.shape
    w, s = weight, styles
    if demodulate:
        w = w * torch.rsqrt(_mean_square(w, (1, 2, 3), keepdim=True))
        s = s * torch.rsqrt(_mean_square(s, None))
    w = w[None] * s[:, None, :, None, None]  # (N, O, I, kh, kw)
    if demodulate:
        dcoefs = torch.rsqrt(w.square().float().sum(dim=(2, 3, 4)).to(w.dtype) + 1e-8)
        w = w * dcoefs[:, :, None, None, None]
    if input_gain is not None:
        w = w.float() * input_gain
    x = x.reshape(1, batch * in_channels, *x.shape[2:])
    w = w.reshape(batch * out_channels, in_channels, kh, kw).to(x.dtype)
    out = F.conv2d(x, w, padding=padding, groups=batch)
    return out.reshape(batch, out_channels, *out.shape[2:])


class SynthesisLayer(nn.Module):
    """Modulated convolution, then `filtered_lrelu` with the layer's
    designed up / down filters (a linear to-RGB layer: no filter, gain 1)."""

    def __init__(self, w_dim: int, spec: dict, conv_clamp: float):
        super().__init__()
        self.is_torgb = spec["is_torgb"]
        self.in_channels, self.conv_kernel = spec["in_channels"], spec["conv_kernel"]
        self.up_factor, self.down_factor = spec["up_factor"], spec["down_factor"]
        self.padding = spec["padding"]
        self.conv_clamp = conv_clamp
        self.affine = FullyConnectedLayer(w_dim, spec["in_channels"])
        k = spec["conv_kernel"]
        self.weight = nn.Parameter(torch.empty(spec["out_channels"], spec["in_channels"], k, k))
        self.bias = nn.Parameter(torch.empty(spec["out_channels"]))
        self.register_buffer("magnitude_ema", torch.ones(()))
        for name in ("up_filter", "down_filter"):
            taps = spec[name]
            self.register_buffer(name, None if taps is None else torch.as_tensor(taps))

    def forward(self, x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        input_gain = torch.rsqrt(self.magnitude_ema)
        styles = self.affine(w)
        if self.is_torgb:
            styles = styles * (1 / np.sqrt(self.in_channels * self.conv_kernel**2))
        x = modulated_conv2d(x.to(dtype), self.weight.to(dtype), styles.to(dtype),
                             padding=self.conv_kernel - 1, demodulate=not self.is_torgb,
                             input_gain=input_gain)
        return filtered_lrelu(
            x, fu=self.up_filter, fd=self.down_filter, b=self.bias.to(x.dtype),
            up=self.up_factor, down=self.down_factor, padding=self.padding,
            gain=1.0 if self.is_torgb else math.sqrt(2), slope=1.0 if self.is_torgb else 0.2,
            clamp=self.conv_clamp)


class SynthesisNetwork(nn.Module):
    """ws (N, num_ws, w_dim) -> images (N, 3, H, W), fp32, about [-1, 1]."""

    def __init__(self, cfg: SynthesisConfig, layers: List[dict]):
        super().__init__()
        self.output_scale = cfg.output_scale
        cutoffs, _, sampling_rates, _, sizes, channels = layer_specs(cfg)
        self.input = SynthesisInput(cfg.w_dim, int(channels[0]), int(sizes[0]),
                                    sampling_rates[0], cutoffs[0])
        self.layer_names = [spec["name"] for spec in layers]
        for spec in layers:
            setattr(self, spec["name"], SynthesisLayer(cfg.w_dim, spec, cfg.conv_clamp))

    def forward(self, ws: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        x = self.input(ws[:, 0])
        for idx, name in enumerate(self.layer_names):
            x = getattr(self, name)(x, ws[:, idx + 1], dtype)
        if self.output_scale != 1:
            x = x * self.output_scale
        return x.float()


class StyleGANXLGenerator(nn.Module):
    """`mapping` and `synthesis` under the upstream names; `forward(ws)` is
    the synthesis in `dtype`."""

    def __init__(self, config: GeneratorConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config, self.dtype = config, dtype
        self.layers = design_layers(config.synthesis)
        self.mapping = MappingNetwork(config)
        self.synthesis = SynthesisNetwork(config.synthesis, self.layers)

    def forward(self, ws: torch.Tensor) -> torch.Tensor:
        return self.synthesis(ws, self.dtype)


def init_params(config: GeneratorConfig, seed: int = 0) -> Dict:
    """The JAX generator's random parameter tree (`init_params`), numpy
    leaves, drawn from `np.random.default_rng(seed)` in JAX's order: the
    same values bit for bit."""
    cfg = config.synthesis
    cutoffs, _, _, _, _, channels = layer_specs(cfg)
    rng = np.random.default_rng(seed)
    c0 = int(channels[0])
    freqs = rng.normal(size=(c0, 2))
    radii = np.sqrt(np.sum(freqs**2, axis=1, keepdims=True))
    freqs = freqs / (radii * np.exp(radii**2) ** 0.25) * cutoffs[0]
    params: Dict = {
        "input": {
            "weight": rng.normal(size=(c0, c0)).astype(np.float32),
            "affine": {
                "weight": np.zeros((4, cfg.w_dim), np.float32),
                "bias": np.array([1, 0, 0, 0], np.float32),
            },
            "transform": np.eye(3, dtype=np.float32),
            "freqs": freqs.astype(np.float32),
            "phases": (rng.random(c0) - 0.5).astype(np.float32),
        }
    }
    for spec in design_layers(cfg):
        params[spec["name"]] = {
            "affine": {
                "weight": rng.normal(size=(spec["in_channels"], cfg.w_dim)).astype(np.float32),
                "bias": np.ones((spec["in_channels"],), np.float32),
            },
            "weight": rng.normal(size=(spec["out_channels"], spec["in_channels"],
                                       spec["conv_kernel"], spec["conv_kernel"])).astype(np.float32),
            "bias": np.zeros((spec["out_channels"],), np.float32),
            "magnitude_ema": np.ones((), np.float32),
        }
    mapping: Dict = {
        "w_avg": np.zeros((config.c_dim, config.w_dim) if config.c_dim else (config.w_dim,),
                          np.float32),
    }
    if config.c_dim:
        mapping["embed"] = rng.normal(size=(config.c_dim, config.embed_dim)).astype(np.float32)
        mapping["embed_proj"] = {
            "weight": rng.normal(size=(config.z_dim, config.embed_dim)).astype(np.float32),
            "bias": np.zeros((config.z_dim,), np.float32),
        }
    features = [config.z_dim * (2 if config.c_dim else 1)] + [config.w_dim] * config.mapping_layers
    for idx in range(config.mapping_layers):
        mapping[f"fc{idx}"] = {
            "weight": (rng.normal(size=(features[idx + 1], features[idx]))
                       * (1 / 0.01)).astype(np.float32) * 0.01,
            "bias": np.zeros((features[idx + 1],), np.float32),
        }
    params["mapping"] = mapping
    return params


def _tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().float()
    return torch.tensor(np.asarray(value, dtype=np.float32))


def params_state_dict(params: Mapping, config: GeneratorConfig) -> Dict[str, torch.Tensor]:
    """A JAX-layout parameter tree ({input, L*, mapping}) -> the port's
    state_dict, fp32 CPU tensors, with the designed filters."""
    sd: Dict[str, torch.Tensor] = {}

    def fc(p, prefix):
        sd[f"{prefix}.weight"] = _tensor(p["weight"])
        if "bias" in p:
            sd[f"{prefix}.bias"] = _tensor(p["bias"])

    inp = params["input"]
    sd["synthesis.input.weight"] = _tensor(inp["weight"])
    fc(inp["affine"], "synthesis.input.affine")
    for key in ("transform", "freqs", "phases"):
        sd[f"synthesis.input.{key}"] = _tensor(inp[key])
    for spec in design_layers(config.synthesis):
        p, prefix = params[spec["name"]], f"synthesis.{spec['name']}"
        fc(p["affine"], f"{prefix}.affine")
        for key in ("weight", "bias", "magnitude_ema"):
            sd[f"{prefix}.{key}"] = _tensor(p[key])
        for key in ("up_filter", "down_filter"):
            if spec[key] is not None:
                sd[f"{prefix}.{key}"] = torch.as_tensor(spec[key])
    mapping = params["mapping"]
    sd["mapping.w_avg"] = _tensor(mapping["w_avg"])
    if "embed" in mapping:
        sd["mapping.embed.weight"] = _tensor(mapping["embed"])
        fc(mapping["embed_proj"], "mapping.embed_proj")
    idx = 0
    while f"fc{idx}" in mapping:
        fc(mapping[f"fc{idx}"], f"mapping.fc{idx}")
        idx += 1
    return sd


def convert_stylegan_xl(state_dict: Mapping, generator: StyleGANXLGenerator) -> Dict[str, torch.Tensor]:
    """A snapshot's generator state_dict (upstream names; tensors or numpy)
    -> `generator`'s state_dict, fp32. The filters are the generator's own
    design, as in JAX. A snapshot with no `mapping.w_avg` is synthesis-only:
    the mapping is JAX's seed-0 random one. An unconditional generator takes
    no `mapping.embed` (real unconditional snapshots still carry the
    table)."""
    own = generator.state_dict()
    if "mapping.w_avg" in state_dict:
        source = state_dict
    else:
        source = {**state_dict, **{
            k: v for k, v in params_state_dict(init_params(generator.config), generator.config).items()
            if k.startswith("mapping.")}}
    return {key: (value.detach().clone() if key.endswith("_filter") else _tensor(source[key]))
            for key, value in own.items()}


@cache
class StyleGANXL:
    def __init__(self, name: str = "imagenet128", device="cuda",
                 dtype: torch.dtype = torch.bfloat16):
        """The generator of `name` (MODEL_CONFIGS) on `device` (CUDA unless
        the caller passes "cpu"), computing its synthesis in `dtype` (bf16,
        as JAX's wrapper; fp32 for a reference build), frozen. Its weights
        come from `find_checkpoint("stylegan_xl_<name>", name)` when a file
        is found (`utils.checkpoints.load_found`), else JAX's seed-0 random draw, the same
        weights as the JAX wrapper's. Memoized on its arguments."""
        if name not in MODEL_CONFIGS:
            raise ValueError(f"unknown stylegan-xl model: {name}")
        self.name = name
        self.config = MODEL_CONFIGS[name]
        self.device = resolve_device(device)
        self.generator = StyleGANXLGenerator(self.config, dtype=dtype)
        path = find_checkpoint(f"stylegan_xl_{name}", name)
        if path is not None:
            load_found(path, {"generator": self.generator},
                       lambda params: {"generator": params_state_dict(params, self.config)},
                       self.load_state_dict)
        else:
            self.generator.load_state_dict(
                params_state_dict(init_params(self.config), self.config))
        self.generator.to(self.device).requires_grad_(False).eval()

    def load_state_dict(self, state_dict: Mapping) -> None:
        """A snapshot's generator state_dict (see `convert_stylegan_xl`)."""
        self.generator.load_state_dict(convert_stylegan_xl(state_dict, self.generator))

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The generator's parameters and buffers by name."""
        return {**dict(self.generator.named_parameters()), **dict(self.generator.named_buffers())}

    @property
    def num_ws(self) -> int:
        return self.config.synthesis.num_ws

    @property
    def w_dim(self) -> int:
        return self.config.w_dim

    def forward(self, latents: torch.Tensor) -> torch.Tensor:
        """w latents (N, num_ws, w_dim) -> images in [0, 1]."""
        return (self.generator(latents) + 1) / 2

    __call__ = forward

    def synthesis_fn(self, params: Mapping, latents: torch.Tensor) -> torch.Tensor:
        """`forward` with the generator's tensors taken from `params`."""
        return (torch.func.functional_call(self.generator, dict(params), (latents,)) + 1) / 2

    @torch.no_grad()
    def latents(self, size: int, seeds=None, class_indices=None,
                truncation_psi: float = 0.7) -> torch.Tensor:
        """w latents (size, num_ws, w_dim), fp32: z of each seed from
        `np.random.default_rng(seed).standard_normal`, the class (when not
        given) from the same seed's `integers(c_dim)`, truncated by
        `truncation_psi`."""
        if seeds is None:
            seeds = list(range(size))
        zs = np.stack([np.random.default_rng(seed).standard_normal(self.config.z_dim)
                       for seed in seeds]).astype(np.float32)
        if self.config.c_dim and class_indices is None:
            class_indices = [int(np.random.default_rng(seed).integers(self.config.c_dim))
                             for seed in seeds]
        return self.generator.mapping(torch.as_tensor(zs, device=self.device), class_indices,
                                      truncation_psi)
