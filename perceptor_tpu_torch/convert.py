"""JAX (flax) parameter trees -> the port's state_dicts.

Each function takes the JAX package's flax param tree as numpy arrays and
returns a state_dict for the port's module, inverting the rules of the JAX
converters (perceptor_tpu/models/stable_diffusion/convert.py,
perceptor_tpu/models/clip/convert.py,
perceptor_tpu/models/guided_diffusion/convert.py,
perceptor_tpu/models/velocity_diffusion/convert.py,
perceptor_tpu/models/monster_diffusion/convert.py,
perceptor_tpu/models/latent_diffusion/bert.py and first_stage.py,
perceptor_tpu/models/vgg.py, lpips.py, resnet.py, resmem.py,
adabins_depth.py and midas_depth.py):

    conv   (kh, kw, I, O) -> (O, I, kh, kw)
    dense  (I, O)         -> (O, I)      (ADM's 1x1 conv1d: (O, I, 1))
    norm   scale          -> weight

The port's keys are diffusers' (UNet, VAE, the VQ stage's backbone),
open_clip's (CLIP, both image towers), OpenAI guided_diffusion's (ADM;
CompVis's for its spatial transformers), k-diffusion's (MonsterDiffusion)
x-transformer's (BERT), torchvision's (the VGG, AlexNet, SqueezeNet and
ResNet trunks), lpips' (its heads), ResMem's, gen-efficientnet's, the
AdaBins repository's and MiDaS's (timm's ViT inside), so the JAX package's
own `unet_from_diffusers`, `vae_from_diffusers`, `from_openclip`, the three
`from_torch`, `convert_bert`, `convert_torchvision_features`,
`convert_resnet`, `convert_resmem`, `convert_efficientnet`,
`convert_adabins`, `convert_dpt`, `convert_midas_net` and
`convert_midas_net_small` map these state_dicts back to the same trees.

One map is torch to torch: `open_clip_state_dict_from_hf` takes an HF
`transformers` CLIPModel state_dict to the port's open_clip names.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from perceptor_tpu_torch.models.adabins_depth import AdaBinsConfig, EfficientNetConfig
from perceptor_tpu_torch.models.clip.configs import CLIPConfig
from perceptor_tpu_torch.models.guided_diffusion.config import ADMConfig
from perceptor_tpu_torch.models.latent_diffusion.bert import BERTConfig
from perceptor_tpu_torch.models.midas_depth import DPTConfig, MidasNetConfig, MidasNetSmallConfig
from perceptor_tpu_torch.models.monster_diffusion.net import MonsterConfig
from perceptor_tpu_torch.models.stable_diffusion.config import TextConfig, UNetConfig, VAEConfig
from perceptor_tpu_torch.models.velocity_diffusion.configs import VNetConfig
from perceptor_tpu_torch.models.vgg import VGG16_CFG, VGG19_CFG
from perceptor_tpu_torch.models.vgg import _layers as vgg_layers
from perceptor_tpu_torch.ops.upfirdn import fir_taps

StateDict = Dict[str, torch.Tensor]


def _t(array) -> torch.Tensor:
    return torch.tensor(np.asarray(array, dtype=np.float32))


def _conv(p: Mapping, prefix: str, sd: StateDict) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _linear(p: Mapping, prefix: str, sd: StateDict) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _norm(p: Mapping, prefix: str, sd: StateDict) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _resnet(p: Mapping, prefix: str, sd: StateDict) -> None:
    _norm(p["norm1"], f"{prefix}.norm1", sd)
    _conv(p["conv1"], f"{prefix}.conv1", sd)
    _norm(p["norm2"], f"{prefix}.norm2", sd)
    _conv(p["conv2"], f"{prefix}.conv2", sd)
    if "time_emb_proj" in p:
        _linear(p["time_emb_proj"], f"{prefix}.time_emb_proj", sd)
    if "conv_shortcut" in p:
        _conv(p["conv_shortcut"], f"{prefix}.conv_shortcut", sd)


def _cross_attention(p: Mapping, prefix: str, sd: StateDict) -> None:
    for name in ("to_q", "to_k", "to_v"):
        _linear(p[name], f"{prefix}.{name}", sd)
    _linear(p["to_out_0"], f"{prefix}.to_out.0", sd)


def _spatial_transformer(p: Mapping, prefix: str, depth: int, sd: StateDict) -> None:
    _norm(p["norm"], f"{prefix}.norm", sd)
    _conv(p["proj_in"], f"{prefix}.proj_in", sd)
    _conv(p["proj_out"], f"{prefix}.proj_out", sd)
    for k in range(depth):
        block, bp = f"{prefix}.transformer_blocks.{k}", p[f"transformer_blocks_{k}"]
        for norm in ("norm1", "norm2", "norm3"):
            _norm(bp[norm], f"{block}.{norm}", sd)
        _cross_attention(bp["attn1"], f"{block}.attn1", sd)
        _cross_attention(bp["attn2"], f"{block}.attn2", sd)
        _linear(bp["ff"]["net_0_proj"], f"{block}.ff.net.0.proj", sd)
        _linear(bp["ff"]["net_2"], f"{block}.ff.net.2", sd)


def unet_state_dict_from_jax(params: Mapping, cfg: UNetConfig) -> StateDict:
    """Flax `UNet` params -> state_dict of the port's (diffusers-named) UNet."""
    sd: StateDict = {}
    _conv(params["conv_in"], "conv_in", sd)
    _linear(params["time_embedding"]["linear_1"], "time_embedding.linear_1", sd)
    _linear(params["time_embedding"]["linear_2"], "time_embedding.linear_2", sd)
    _norm(params["conv_norm_out"], "conv_norm_out", sd)
    _conv(params["conv_out"], "conv_out", sd)
    _resnet(params["mid_block_resnets_0"], "mid_block.resnets.0", sd)
    _resnet(params["mid_block_resnets_1"], "mid_block.resnets.1", sd)
    _spatial_transformer(
        params["mid_block_attentions_0"], "mid_block.attentions.0", cfg.transformer_depth, sd
    )
    n_levels = len(cfg.channel_mults)
    for i in range(n_levels):
        for j in range(cfg.n_res_blocks):
            _resnet(params[f"down_blocks_{i}_resnets_{j}"], f"down_blocks.{i}.resnets.{j}", sd)
            if cfg.cross_attention[i]:
                _spatial_transformer(
                    params[f"down_blocks_{i}_attentions_{j}"],
                    f"down_blocks.{i}.attentions.{j}", cfg.transformer_depth, sd,
                )
        if i < n_levels - 1:
            _conv(
                params[f"down_blocks_{i}_downsamplers_0"]["conv"],
                f"down_blocks.{i}.downsamplers.0.conv", sd,
            )
    for i in range(n_levels):
        level = n_levels - 1 - i
        for j in range(cfg.n_res_blocks + 1):
            _resnet(params[f"up_blocks_{i}_resnets_{j}"], f"up_blocks.{i}.resnets.{j}", sd)
            if cfg.cross_attention[level]:
                _spatial_transformer(
                    params[f"up_blocks_{i}_attentions_{j}"],
                    f"up_blocks.{i}.attentions.{j}", cfg.transformer_depth, sd,
                )
        if level > 0:
            _conv(
                params[f"up_blocks_{i}_upsamplers_0"]["conv"],
                f"up_blocks.{i}.upsamplers.0.conv", sd,
            )
    return sd


def _vae_attention(p: Mapping, prefix: str, sd: StateDict) -> None:
    _norm(p["group_norm"], f"{prefix}.group_norm", sd)
    _cross_attention(p, prefix, sd)


def _vae_mid(p: Mapping, prefix: str, sd: StateDict) -> None:
    _resnet(p["resnets_0"], f"{prefix}.resnets.0", sd)
    _resnet(p["resnets_1"], f"{prefix}.resnets.1", sd)
    if "attentions_0" in p:
        _vae_attention(p["attentions_0"], f"{prefix}.attentions.0", sd)


def vae_state_dict_from_jax(params: Mapping, cfg: VAEConfig) -> StateDict:
    """Flax `AutoencoderKL` params -> state_dict of the port's (diffusers-named) VAE."""
    sd: StateDict = {}
    n_levels = len(cfg.channel_mults)
    enc, dec = params["encoder"], params["decoder"]
    _conv(enc["conv_in"], "encoder.conv_in", sd)
    _vae_mid(enc["mid_block"], "encoder.mid_block", sd)
    _norm(enc["conv_norm_out"], "encoder.conv_norm_out", sd)
    _conv(enc["conv_out"], "encoder.conv_out", sd)
    for i in range(n_levels):
        for j in range(cfg.n_res_blocks):
            _resnet(enc[f"down_blocks_{i}_resnets_{j}"], f"encoder.down_blocks.{i}.resnets.{j}", sd)
            if i in cfg.encoder_attn_levels:
                _vae_attention(
                    enc[f"down_blocks_{i}_attentions_{j}"],
                    f"encoder.down_blocks.{i}.attentions.{j}", sd,
                )
        if i < n_levels - 1:
            _conv(
                enc[f"down_blocks_{i}_downsamplers_0_conv"],
                f"encoder.down_blocks.{i}.downsamplers.0.conv", sd,
            )
    _conv(dec["conv_in"], "decoder.conv_in", sd)
    _vae_mid(dec["mid_block"], "decoder.mid_block", sd)
    _norm(dec["conv_norm_out"], "decoder.conv_norm_out", sd)
    _conv(dec["conv_out"], "decoder.conv_out", sd)
    for i in range(n_levels):
        for j in range(cfg.n_res_blocks + 1):
            _resnet(dec[f"up_blocks_{i}_resnets_{j}"], f"decoder.up_blocks.{i}.resnets.{j}", sd)
            if i in cfg.decoder_attn_levels:
                _vae_attention(
                    dec[f"up_blocks_{i}_attentions_{j}"],
                    f"decoder.up_blocks.{i}.attentions.{j}", sd,
                )
        if i < n_levels - 1:
            _conv(
                dec[f"up_blocks_{i}_upsamplers_0_conv"],
                f"decoder.up_blocks.{i}.upsamplers.0.conv", sd,
            )
    _conv(params["quant_conv"], "quant_conv", sd)
    _conv(params["post_quant_conv"], "post_quant_conv", sd)
    return sd


def _transformer(p: Mapping, prefix: str, layers: int, sd: StateDict) -> None:
    """Flax CLIP `Transformer` -> open_clip `resblocks.{i}`; q/k/v
    projections are packed into `attn.in_proj_weight`/`in_proj_bias` as
    open_clip stores them."""
    for i in range(layers):
        bp, block = p[f"resblocks_{i}"], f"{prefix}.resblocks.{i}"
        _norm(bp["ln_1"], f"{block}.ln_1", sd)
        _norm(bp["ln_2"], f"{block}.ln_2", sd)
        attn = bp["attn"]
        sd[f"{block}.attn.in_proj_weight"] = _t(
            np.concatenate([np.asarray(attn[n]["kernel"]).T for n in ("q_proj", "k_proj", "v_proj")])
        )
        sd[f"{block}.attn.in_proj_bias"] = _t(
            np.concatenate([np.asarray(attn[n]["bias"]) for n in ("q_proj", "k_proj", "v_proj")])
        )
        _linear(attn["out_proj"], f"{block}.attn.out_proj", sd)
        _linear(bp["mlp"]["fc1"], f"{block}.mlp.c_fc", sd)
        _linear(bp["mlp"]["fc2"], f"{block}.mlp.c_proj", sd)


def _batch_norm(p: Mapping, prefix: str, sd: StateDict) -> None:
    _norm(p, prefix, sd)
    sd[f"{prefix}.running_mean"] = _t(p["mean"])
    sd[f"{prefix}.running_var"] = _t(p["var"])


def _modified_resnet_visual(visual: Mapping, cfg: CLIPConfig) -> StateDict:
    """Flax `ModifiedResNet` params -> open_clip's `visual.*` names (the
    inverse of the JAX converter's `_modified_resnet_visual`)."""
    sd: StateDict = {}
    for i in (1, 2, 3):
        _conv(visual[f"conv{i}"], f"visual.conv{i}", sd)
        _batch_norm(visual[f"bn{i}"], f"visual.bn{i}", sd)
    for stage, count in enumerate(cfg.vision_layers):
        for i in range(count):
            block, prefix = visual[f"layer{stage + 1}_{i}"], f"visual.layer{stage + 1}.{i}"
            for j in (1, 2, 3):
                _conv(block[f"conv{j}"], f"{prefix}.conv{j}", sd)
                _batch_norm(block[f"bn{j}"], f"{prefix}.bn{j}", sd)
            if "downsample_conv" in block:
                _conv(block["downsample_conv"], f"{prefix}.downsample.0", sd)
                _batch_norm(block["downsample_bn"], f"{prefix}.downsample.1", sd)
    pool = visual["attnpool"]
    sd["visual.attnpool.positional_embedding"] = _t(pool["positional_embedding"])
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        _linear(pool[name], f"visual.attnpool.{name}", sd)
    return sd


def clip_visual_state_dict_from_jax(visual: Mapping, cfg: CLIPConfig) -> StateDict:
    """Flax `VisionTransformer` or `ModifiedResNet` params
    (`params["visual"]`) -> the port's open_clip-named `visual.*`
    state_dict."""
    if cfg.is_resnet:
        return _modified_resnet_visual(visual, cfg)
    sd: StateDict = {}
    sd["visual.conv1.weight"] = _t(np.asarray(visual["conv1"]["kernel"]).transpose(3, 2, 0, 1))
    sd["visual.class_embedding"] = _t(visual["class_embedding"])
    sd["visual.positional_embedding"] = _t(visual["positional_embedding"])
    sd["visual.proj"] = _t(visual["proj"])
    _norm(visual["ln_pre"], "visual.ln_pre", sd)
    _norm(visual["ln_post"], "visual.ln_post", sd)
    _transformer(visual["transformer"], "visual.transformer", cfg.vision_layers, sd)
    return sd


def clip_state_dict_from_jax(params: Mapping, cfg: CLIPConfig) -> StateDict:
    """Flax `CLIP` params ({"visual", "text", "logit_scale"}) -> the port's
    open_clip-named state_dict: `visual.*`, the text tower at the top level
    and `logit_scale`."""
    sd = clip_visual_state_dict_from_jax(params["visual"], cfg)
    text = params["text"]
    sd["token_embedding.weight"] = _t(text["token_embedding"])
    sd["positional_embedding"] = _t(text["positional_embedding"])
    sd["text_projection"] = _t(text["text_projection"])
    _norm(text["ln_final"], "ln_final", sd)
    _transformer(text["transformer"], "transformer", cfg.text_layers, sd)
    sd["logit_scale"] = _t(params["logit_scale"])
    return sd


def text_encoder_state_dict_from_jax(params: Mapping, cfg: TextConfig) -> StateDict:
    """Flax SD `CLIPTextEncoder` params -> state_dict of the port's
    `CLIPTextEncoder` (open_clip text-tower names)."""
    sd: StateDict = {
        "token_embedding.weight": _t(params["token_embedding"]),
        "positional_embedding": _t(params["positional_embedding"]),
    }
    _transformer(params["transformer"], "transformer", cfg.layers, sd)
    _norm(params["ln_final"], "ln_final", sd)
    return sd


def stable_diffusion_state_dicts_from_jax(
    params: Mapping, unet_cfg: UNetConfig, vae_cfg: VAEConfig, text_cfg: TextConfig
) -> Dict[str, StateDict]:
    """The JAX `StableDiffusion.params` tree ({"unet", "vae",
    "text_encoder"}) -> the port's three state_dicts under the same keys, as
    `StableDiffusion.load_state_dicts` takes them."""
    return {
        "unet": unet_state_dict_from_jax(params["unet"], unet_cfg),
        "vae": vae_state_dict_from_jax(params["vae"], vae_cfg),
        "text_encoder": text_encoder_state_dict_from_jax(params["text_encoder"], text_cfg),
    }


def _conv1d(p: Mapping, prefix: str, sd: StateDict) -> None:
    """A flax dense kernel (I, O) -> a kernel-size-1 conv1d weight (O, I, 1)."""
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T[:, :, None])
    sd[f"{prefix}.bias"] = _t(p["bias"])


_ADM_BLOCK = re.compile(r"(input_blocks|output_blocks|middle_block)_(?:(\d+)_)?(\d+)(_op|_conv)?$")


def adm_state_dict_from_jax(params: Mapping, cfg: ADMConfig) -> StateDict:
    """Flax `ADMUNet` params -> state_dict of the port's (OpenAI-named)
    ADMUNet; the inverse of the JAX package's `guided_diffusion/convert.py
    from_torch`. A `spatial_transformer` config's attention blocks are
    SD spatial transformers under CompVis's names."""
    sd: StateDict = {}
    for name, p in params.items():
        if name in ("time_embed_0", "time_embed_2"):
            _linear(p, f"time_embed.{name[-1]}", sd)
        elif name == "out_norm":
            _norm(p, "out.0", sd)
        elif name == "out_conv":
            _conv(p, "out.2", sd)
        elif name == "input_blocks_0_0":
            _conv(p, "input_blocks.0.0", sd)
        else:
            match = _ADM_BLOCK.match(name)
            if not match:
                raise ValueError(f"unrecognized ADM module: {name}")
            group, index, sub, resampler = match.groups()
            prefix = ".".join(x for x in (group, index, sub) if x is not None)
            if resampler:  # Downsample `op` / Upsample `conv`
                _conv(p, f"{prefix}.{resampler[1:]}", sd)
            elif "proj_in" in p:
                _spatial_transformer(p, prefix, cfg.transformer_depth, sd)
            elif "qkv" in p:
                _norm(p["norm"], f"{prefix}.norm", sd)
                _conv1d(p["qkv"], f"{prefix}.qkv", sd)
                _conv1d(p["proj_out"], f"{prefix}.proj_out", sd)
            else:
                _norm(p["norm1"], f"{prefix}.in_layers.0", sd)
                _conv(p["conv1"], f"{prefix}.in_layers.2", sd)
                _linear(p["emb_proj"], f"{prefix}.emb_layers.1", sd)
                _norm(p["norm2"], f"{prefix}.out_layers.0", sd)
                _conv(p["conv2"], f"{prefix}.out_layers.3", sd)
                if "skip" in p:
                    _conv(p["skip"], f"{prefix}.skip_connection", sd)
    return sd


def vnet_state_dict_from_jax(params: Mapping, cfg: VNetConfig) -> StateDict:
    """Flax `VDiffusionUNet` params -> state_dict of the port's
    VDiffusionUNet (the JAX module names under `blocks.`, each block's
    layers under `main` and `skip`); the inverse of the JAX package's
    `velocity_diffusion/convert.py from_torch`."""
    sd: StateDict = {}
    for name, p in params.items():
        if name in ("timestep_embed", "mapping_timestep_embed"):
            sd[f"{name}.weight"] = _t(p["weight"])
        elif name in ("mapping_0", "mapping_1"):
            _linear(p["fc1"], f"{name}.main.fc1", sd)
            _linear(p["fc2"], f"{name}.main.fc2", sd)
            if "skip" in p:
                _linear(p["skip"], f"{name}.skip", sd)
        elif name.endswith("_attn"):
            prefix = f"blocks.{name}"
            if cfg.attn_norm:
                _norm(p["norm"], f"{prefix}.norm", sd)
            _conv(p["qkv_proj"], f"{prefix}.qkv_proj", sd)
            _conv(p["out_proj"], f"{prefix}.out_proj", sd)
        else:
            prefix = f"blocks.{name}"
            for layer, lp in p.items():
                if layer == "skip":
                    _conv(lp, f"{prefix}.skip", sd)
                elif layer.endswith("_mod"):
                    _linear(lp, f"{prefix}.main.{layer}", sd)
                else:
                    _conv(lp, f"{prefix}.main.{layer}", sd)
    return sd


def bert_state_dict_from_jax(params: Mapping, cfg: BERTConfig) -> StateDict:
    """Flax `BERTEncoder` params -> state_dict of the port's (x-transformer
    named) BERTEncoder; the inverse of the JAX package's `convert_bert`."""
    sd: StateDict = {
        "token_emb.weight": _t(params["token_emb"]),
        "pos_emb.emb.weight": _t(params["pos_emb"]),
    }
    _norm(params["final_norm"], "norm", sd)
    for i in range(cfg.depth):
        attn, ff = f"attn_layers.layers.{2 * i}", f"attn_layers.layers.{2 * i + 1}"
        _norm(params[f"attn_norm_{i}"], f"{attn}.0", sd)
        for name in ("to_q", "to_k", "to_v", "to_out"):
            _linear(params[f"attn_{i}"][name], f"{attn}.1.{name}", sd)
        _norm(params[f"ff_norm_{i}"], f"{ff}.0", sd)
        _linear(params[f"ff_{i}_proj"], f"{ff}.1.net.0.0", sd)
        _linear(params[f"ff_{i}_out"], f"{ff}.1.net.2", sd)
    return sd


def vq_state_dict_from_jax(params: Mapping, cfg: VAEConfig) -> StateDict:
    """Flax `VQModel` params -> state_dict of the port's VQModel: the
    diffusers-named backbone and the codebook `quantize.embedding.weight`."""
    sd = vae_state_dict_from_jax(params, cfg)
    sd["quantize.embedding.weight"] = _t(params["quantize"]["embedding"])
    return sd


def text2image_state_dicts_from_jax(
    params: Mapping, unet_cfg: ADMConfig, vae_cfg: VAEConfig, bert_cfg: BERTConfig
) -> Dict[str, StateDict]:
    """The JAX `Text2Image.params` tree ({"unet", "first_stage", "bert"}) ->
    the port's three state_dicts under the same keys, as
    `Text2Image.load_state_dicts` takes them."""
    return {
        "unet": adm_state_dict_from_jax(params["unet"], unet_cfg),
        "first_stage": vae_state_dict_from_jax(params["first_stage"], vae_cfg),
        "bert": bert_state_dict_from_jax(params["bert"], bert_cfg),
    }


def vq_diffusion_state_dicts_from_jax(
    params: Mapping, unet_cfg: ADMConfig, vq_cfg: VAEConfig
) -> Dict[str, StateDict]:
    """The JAX `Face.params` or `SuperResolution.params` tree ({"unet",
    "first_stage"}) -> the port's state_dicts under the same keys, as their
    `load_state_dicts` takes them."""
    return {
        "unet": adm_state_dict_from_jax(params["unet"], unet_cfg),
        "first_stage": vq_state_dict_from_jax(params["first_stage"], vq_cfg),
    }


def monster_state_dict_from_jax(params: Mapping, cfg: MonsterConfig) -> StateDict:
    """Flax `MonsterUNet` params -> state_dict of the port's (k-diffusion
    named) MonsterUNet, the resamplers' fixed `kernel` buffers included;
    the inverse of the JAX package's `monster_diffusion/convert.py
    from_torch`."""
    sd: StateDict = {"timestep_embed.weight": _t(params["timestep_embed"]["weight"])}
    _linear(params["mapping_cond"], "mapping_cond", sd)
    _linear(params["mapping_0"], "mapping.0", sd)
    _linear(params["mapping_1"], "mapping.2", sd)
    _conv(params["proj_in"], "proj_in", sd)
    _conv(params["proj_out"], "proj_out", sd)
    levels = len(cfg.depths)

    def blocks(kind, i, prefix, first):
        index = first
        for j in range(cfg.depths[i]):
            res, block = params[f"{kind}_{i}_res_{j}"], f"{prefix}.{index}"
            _linear(res["norm1"]["mapper"], f"{block}.main.0.mapper", sd)
            _conv(res["conv1"], f"{block}.main.2", sd)
            _linear(res["norm2"]["mapper"], f"{block}.main.4.mapper", sd)
            _conv(res["conv2"], f"{block}.main.6", sd)
            if "skip" in res:
                _conv(res["skip"], f"{block}.skip", sd)
            index += 1
            if cfg.self_attn_depths[i]:
                attn, block = params[f"{kind}_{i}_attn_{j}"], f"{prefix}.{index}"
                _linear(attn["norm_in"]["mapper"], f"{block}.norm_in.mapper", sd)
                _conv(attn["qkv_proj"], f"{block}.qkv_proj", sd)
                _conv(attn["out_proj"], f"{block}.out_proj", sd)
                index += 1
        return index

    for i in range(levels):  # [Identity, Downsample2d below level 0, blocks]
        prefix = f"u_net.d_blocks.{i}"
        if i > 0:
            sd[f"{prefix}.1.kernel"] = fir_taps("linear")
        blocks("d", i, prefix, 2 if i > 0 else 1)
    for k, i in enumerate(reversed(range(levels))):  # innermost first; [blocks, Upsample2d]
        prefix = f"u_net.u_blocks.{k}"
        end = blocks("u", i, prefix, 0)
        if i > 0:
            sd[f"{prefix}.{end}.kernel"] = fir_taps("linear", gain=2.0)
    return sd


def _vgg_convs(params: Mapping, cfg, sd: StateDict, prefix: str = "features") -> None:
    """Flax `conv_{k}` of a VGG trunk -> torchvision `features.{i}`, i the
    k-th conv's index in `cfg`'s layer list."""
    indices = [i for i, (kind, _) in enumerate(vgg_layers(cfg)) if kind == "conv"]
    for k, index in enumerate(indices):
        if f"conv_{k}" in params:
            _conv(params[f"conv_{k}"], f"{prefix}.{index}", sd)


def vgg_state_dict_from_jax(params: Mapping, cfg=VGG19_CFG) -> StateDict:
    """Flax `VGGFeatures` params -> the port's `VGGFeatures` state_dict
    (torchvision's `features.{i}`); the inverse of the JAX package's
    `models/vgg.py convert_torchvision_features`."""
    sd: StateDict = {}
    _vgg_convs(params, cfg, sd)
    return sd


def lpips_state_dict_from_jax(params: Mapping, name: str) -> StateDict:
    """The JAX `LPIPS.params` ({"backbone", "lins"}) of backbone `name` ->
    the port's `LPIPSNet` state_dict: the trunk under torchvision's
    `features.*`, the (C, 1) heads as lpips' `lin{k}.model.1.weight`
    (1, C, 1, 1)."""
    backbone, sd = params["backbone"], {}
    if name == "vgg":
        _vgg_convs(backbone, VGG16_CFG, sd)
    elif name == "alex":
        for k, index in enumerate((0, 3, 6, 8, 10)):
            _conv(backbone[f"conv_{k}"], f"features.{index}", sd)
    else:  # squeezenet1_1
        _conv(backbone["conv_0"], "features.0", sd)
        for index in (3, 4, 6, 7, 9, 10, 11, 12):
            for part in ("squeeze", "expand1x1", "expand3x3"):
                _conv(backbone[f"fire_{index}"][part], f"features.{index}.{part}", sd)
    for k, lin in enumerate(params["lins"]):
        sd[f"lin{k}.model.1.weight"] = _t(np.asarray(lin).T[:, :, None, None])
    return sd


def resnet_state_dict_from_jax(params: Mapping, prefix: str = "") -> StateDict:
    """Flax `ResNetFeatures` params -> torchvision ResNet names under
    `prefix`; the inverse of the JAX package's `models/resnet.py
    convert_resnet`."""
    sd: StateDict = {}
    _conv(params["conv1"], f"{prefix}conv1", sd)
    _batch_norm(params["bn1"], f"{prefix}bn1", sd)
    for key, block in params.items():
        if not key.startswith("layer"):
            continue
        stage, i = key.split("_")
        dst = f"{prefix}{stage}.{i}"
        for j in (1, 2, 3):
            _conv(block[f"conv{j}"], f"{dst}.conv{j}", sd)
            _batch_norm(block[f"bn{j}"], f"{dst}.bn{j}", sd)
        if "downsample_conv" in block:
            _conv(block["downsample_conv"], f"{dst}.downsample.0", sd)
            _batch_norm(block["downsample_bn"], f"{dst}.downsample.1", sd)
    return sd


def resmem_state_dict_from_jax(params: Mapping) -> StateDict:
    """Flax `ResMemNet` params -> the port's upstream-named `ResMemNet`
    state_dict; the inverse of the JAX package's `models/resmem.py
    convert_resmem`. JAX flattens the pooled AlexNet map in (H, W, C)
    order, torch in (C, H, W): the fc6 kernel (s * s * C, out) becomes the
    weight (out, C * s * s), C the last conv's width."""
    alexnet = params["alexnet"]
    sd: StateDict = {}
    for k, index in enumerate((0, 3, 6, 8, 10)):
        _conv(alexnet[f"conv{k + 1}"], f"features.{index}", sd)
    kernel = np.asarray(alexnet["fc6"]["kernel"])
    channels = np.asarray(alexnet["conv5"]["kernel"]).shape[-1]
    side = int(round((kernel.shape[0] // channels) ** 0.5))
    sd["fc6.weight"] = _t(
        kernel.reshape(side, side, channels, -1).transpose(3, 2, 0, 1).reshape(kernel.shape[1], -1))
    sd["fc6.bias"] = _t(alexnet["fc6"]["bias"])
    _linear(alexnet["fc7"], "fc7", sd)
    sd.update(resnet_state_dict_from_jax(params["resnet"], prefix="resnet."))
    for name in ("head1", "head2", "head3"):
        _linear(params[name], name, sd)
    return sd


def _hf_blocks(hf: Mapping, src: str, dst: str, layers: int, sd: StateDict) -> None:
    """HF `encoder.layers.{i}` -> open_clip `resblocks.{i}`: q / k / v
    packed into `attn.in_proj_*`, `fc1` / `fc2` as `c_fc` / `c_proj`."""
    renames = (("layer_norm1", "ln_1"), ("layer_norm2", "ln_2"),
               ("self_attn.out_proj", "attn.out_proj"), ("mlp.fc1", "mlp.c_fc"),
               ("mlp.fc2", "mlp.c_proj"))
    for i in range(layers):
        s, d = f"{src}.{i}", f"{dst}.{i}"
        for param in ("weight", "bias"):
            for a, b in renames:
                sd[f"{d}.{b}.{param}"] = torch.as_tensor(hf[f"{s}.{a}.{param}"])
            sd[f"{d}.attn.in_proj_{param}"] = torch.cat(
                [torch.as_tensor(hf[f"{s}.self_attn.{n}_proj.{param}"]) for n in "qkv"])


def open_clip_state_dict_from_hf(hf_state_dict: Mapping, cfg: CLIPConfig) -> StateDict:
    """An HF `transformers` CLIPModel state_dict -> the port's open_clip
    names (the torch counterpart of the JAX package's
    `models/clip/convert.py from_hf`): split q / k / v packed, `fc1` /
    `fc2` renamed, HF's `pre_layrnorm` spelling read, the (embed, width)
    `visual_projection` / `text_projection` transposed, `position_ids`
    dropped. ViT towers only: HF has no ModifiedResNet."""
    if cfg.is_resnet:
        raise ValueError("HF CLIPModel checkpoints hold ViT towers only")
    hf = hf_state_dict

    def get(key):
        return torch.as_tensor(hf[key])

    sd: StateDict = {
        "visual.conv1.weight": get("vision_model.embeddings.patch_embedding.weight"),
        "visual.class_embedding": get("vision_model.embeddings.class_embedding"),
        "visual.positional_embedding": get("vision_model.embeddings.position_embedding.weight"),
        "visual.proj": get("visual_projection.weight").t().contiguous(),
        "token_embedding.weight": get("text_model.embeddings.token_embedding.weight"),
        "positional_embedding": get("text_model.embeddings.position_embedding.weight"),
        "text_projection": get("text_projection.weight").t().contiguous(),
        "logit_scale": get("logit_scale"),
    }
    for dst, src in (("visual.ln_pre", "vision_model.pre_layrnorm"),
                     ("visual.ln_post", "vision_model.post_layernorm"),
                     ("ln_final", "text_model.final_layer_norm")):
        sd[f"{dst}.weight"], sd[f"{dst}.bias"] = get(f"{src}.weight"), get(f"{src}.bias")
    _hf_blocks(hf, "vision_model.encoder.layers", "visual.transformer.resblocks",
               cfg.vision_layers, sd)
    _hf_blocks(hf, "text_model.encoder.layers", "transformer.resblocks", cfg.text_layers, sd)
    return sd


def efficientnet_state_dict_from_jax(params: Mapping, cfg: EfficientNetConfig,
                                     prefix: str = "") -> StateDict:
    """Flax `EfficientNetFeatures` params -> gen-efficientnet names under
    `prefix` (`conv_stem`, `bn1`, `blocks.{s}.{i}.*`, `conv_head`); the
    inverse of the JAX package's `models/adabins_depth.py
    convert_efficientnet`. A depthwise kernel (k, k, 1, C) becomes (C, 1, k, k)
    by the conv rule."""
    sd: StateDict = {}
    _conv(params["conv_stem"], f"{prefix}conv_stem", sd)
    _batch_norm(params["bn1"], f"{prefix}bn1", sd)
    for s, spec in enumerate(cfg.blocks):
        for i in range(spec.count):
            block, dst = params[f"blocks_{s}_{i}"], f"{prefix}blocks.{s}.{i}"
            for name, p in block.items():
                if name == "se":
                    _conv(p["conv_reduce"], f"{dst}.se.conv_reduce", sd)
                    _conv(p["conv_expand"], f"{dst}.se.conv_expand", sd)
                elif name.startswith("bn"):
                    _batch_norm(p, f"{dst}.{name}", sd)
                else:
                    _conv(p, f"{dst}.{name}", sd)
    if cfg.include_head:
        _conv(params["conv_head"], f"{prefix}conv_head", sd)
    return sd


def adabins_state_dict_from_jax(params: Mapping, cfg: AdaBinsConfig) -> StateDict:
    """Flax `UnetAdaptiveBins` params -> the AdaBins repository's names
    (`encoder.original_model.*`, `decoder.*`, `adaptive_bins_layer.*`,
    `conv_out.0`); the inverse of the JAX package's `convert_adabins`. The
    transformer layers' (E, 3E) `in_proj` kernel is torch's
    `self_attn.in_proj_weight` (3E, E)."""
    sd = efficientnet_state_dict_from_jax(params["encoder"], cfg.encoder,
                                          "encoder.original_model.")
    decoder = params["decoder"]
    _conv(decoder["conv2"], "decoder.conv2", sd)
    for up in ("up1", "up2", "up3", "up4"):
        for index, name in ((0, "conv_0"), (3, "conv_3")):
            _conv(decoder[up][name], f"decoder.{up}._net.{index}", sd)
        for index, name in ((1, "bn_1"), (4, "bn_4")):
            _batch_norm(decoder[up][name], f"decoder.{up}._net.{index}", sd)
    _conv(decoder["conv3"], "decoder.conv3", sd)
    bins, dst = params["adaptive_bins_layer"], "adaptive_bins_layer"
    pt = bins["patch_transformer"]
    _conv(pt["embedding_convPxP"], f"{dst}.patch_transformer.embedding_convPxP", sd)
    sd[f"{dst}.patch_transformer.positional_encodings"] = _t(pt["positional_encodings"])
    for i in range(cfg.transformer_layers):
        layer = pt[f"layers_{i}"]
        lp = f"{dst}.patch_transformer.transformer_encoder.layers.{i}"
        sd[f"{lp}.self_attn.in_proj_weight"] = _t(np.asarray(layer["in_proj"]["kernel"]).T)
        sd[f"{lp}.self_attn.in_proj_bias"] = _t(layer["in_proj"]["bias"])
        _linear(layer["out_proj"], f"{lp}.self_attn.out_proj", sd)
        for name in ("linear1", "linear2"):
            _linear(layer[name], f"{lp}.{name}", sd)
        for name in ("norm1", "norm2"):
            _norm(layer[name], f"{lp}.{name}", sd)
    _conv(bins["conv3x3"], f"{dst}.conv3x3", sd)
    for j in (0, 2, 4):
        _linear(bins[f"regressor_{j}"], f"{dst}.regressor.{j}", sd)
    _conv(params["conv_out"], "conv_out.0", sd)
    return sd


def _midas_scratch(params: Mapping, rn: str, head: str, sd: StateDict) -> None:
    """The MiDaS `scratch.*` of a flax DPT / MidasNet / MidasNetSmall:
    `rn.format(j)` -> `layer{j + 1}_rn` for j = 0 .. 3 (DPT's `scratch_{j}`,
    v2.1's `layer{j + 1}_rn`), the fusion blocks' residual units and
    out_conv where the tree has them, and `head.format(k)` for k = 1 .. 3 ->
    `output_conv.{0, 2, 4}`."""
    for j in range(4):
        _conv(params[rn.format(j, j + 1)], f"scratch.layer{j + 1}_rn", sd)
        name, dst = f"refinenet{j + 1}", f"scratch.refinenet{j + 1}"
        for unit in (1, 2):
            for conv in (1, 2):
                key = f"{name}_rcu{unit}_conv{conv}"
                if key in params:
                    _conv(params[key], f"{dst}.resConfUnit{unit}.conv{conv}", sd)
        if f"{name}_out" in params:
            _conv(params[f"{name}_out"], f"{dst}.out_conv", sd)
    for k, index in ((1, 0), (2, 2), (3, 4)):
        _conv(params[head.format(k)], f"scratch.output_conv.{index}", sd)


def dpt_state_dict_from_jax(params: Mapping, cfg: DPTConfig) -> StateDict:
    """Flax `DPTDepthModel` params (plain or hybrid) -> the MiDaS DPT names
    (`pretrained.model.*` timm's, `pretrained.act_postprocess{k}.{0,3,4}`,
    `scratch.*`); the inverse of the JAX package's `convert_dpt`. The
    ConvTranspose2d weights `resample_{0,1}_weight` are in torch's layout
    already."""
    backbone, m = params["backbone"], "pretrained.model"
    sd: StateDict = {}
    _conv(backbone["patch_embed"], f"{m}.patch_embed.proj", sd)
    sd[f"{m}.cls_token"] = _t(backbone["cls_token"])
    sd[f"{m}.pos_embed"] = _t(backbone["pos_embed"])
    if cfg.hybrid:
        stem, b = backbone["stem"], f"{m}.patch_embed.backbone"
        _conv(stem["stem_conv"], f"{b}.stem.conv", sd)
        _norm(stem["stem_norm"], f"{b}.stem.norm", sd)
        for s, count in enumerate(cfg.stem.layers):
            for i in range(count):
                block, dst = stem[f"stage{s}_{i}"], f"{b}.stages.{s}.blocks.{i}"
                for j in (1, 2, 3):
                    _conv(block[f"conv{j}"], f"{dst}.conv{j}", sd)
                    _norm(block[f"norm{j}"], f"{dst}.norm{j}", sd)
                if "downsample_conv" in block:
                    _conv(block["downsample_conv"], f"{dst}.downsample.conv", sd)
                    _norm(block["downsample_norm"], f"{dst}.downsample.norm", sd)
    for i in range(cfg.vit_layers):
        dst = f"{m}.blocks.{i}"
        for src, name in (("norm1", "norm1"), ("norm2", "norm2")):
            _norm(backbone[f"{src}_{i}"], f"{dst}.{name}", sd)
        for src, name in (("qkv", "attn.qkv"), ("attn_proj", "attn.proj"), ("fc1", "mlp.fc1"),
                          ("fc2", "mlp.fc2")):
            _linear(backbone[f"{src}_{i}"], f"{dst}.{name}", sd)
    for idx in range(4):
        if f"readout_{idx}" not in params:  # the hybrid's identity act_postprocess1 / 2
            continue
        pp = f"pretrained.act_postprocess{idx + 1}"
        _linear(params[f"readout_{idx}"], f"{pp}.0.project.0", sd)
        _conv(params[f"project_{idx}"], f"{pp}.3", sd)
        if idx in (0, 1):
            sd[f"{pp}.4.weight"] = _t(params[f"resample_{idx}_weight"])
            sd[f"{pp}.4.bias"] = _t(params[f"resample_{idx}_bias"])
        elif idx == 3:
            _conv(params["resample_3"], f"{pp}.4", sd)
    _midas_scratch(params, "scratch_{0}", "head_conv{}", sd)
    return sd


def midas_net_state_dict_from_jax(params: Mapping, cfg: MidasNetConfig) -> StateDict:
    """Flax `MidasNet` params -> MiDaS v2.1's names: the torchvision trunk
    (`resnet_state_dict_from_jax`) regrouped as `_make_resnet_backbone`
    does (`pretrained.layer1.{0,1,4}` = conv1, bn1, layer1;
    `pretrained.layer{2,3,4}`), then `scratch.*`; the inverse of the JAX
    package's `convert_midas_net`. `cfg` names the model; the map reads the
    trunk's blocks from `params`."""
    regroup = (("conv1.", "pretrained.layer1.0."), ("bn1.", "pretrained.layer1.1."),
               ("layer1.", "pretrained.layer1.4."), ("layer", "pretrained.layer"))
    sd: StateDict = {}
    for key, value in resnet_state_dict_from_jax(params["backbone"]).items():
        old, new = next((old, new) for old, new in regroup if key.startswith(old))
        sd[new + key[len(old):]] = value
    _midas_scratch(params, "layer{1}_rn", "out_conv{}", sd)
    return sd


# the EfficientNet trunk's prefixes -> MidasNetSmall's regrouping
# (`_make_efficientnet_backbone`): layer1 = stem + stages 0-1, layer2 =
# stage 2, layer3 = stages 3-4, layer4 = stages 5-6
_LITE_REGROUP = (
    ("conv_stem.", "pretrained.layer1.0."), ("bn1.", "pretrained.layer1.1."),
    ("blocks.0.", "pretrained.layer1.3."), ("blocks.1.", "pretrained.layer1.4."),
    ("blocks.2.", "pretrained.layer2.0."), ("blocks.3.", "pretrained.layer3.0."),
    ("blocks.4.", "pretrained.layer3.1."), ("blocks.5.", "pretrained.layer4.0."),
    ("blocks.6.", "pretrained.layer4.1."),
)


def midas_net_small_state_dict_from_jax(params: Mapping, cfg: MidasNetSmallConfig) -> StateDict:
    """Flax `MidasNetSmall` params -> midas_v21_small's names: the
    gen-efficientnet trunk regrouped into `pretrained.layer{1-4}`, then
    `scratch.*`; the inverse of the JAX package's
    `convert_midas_net_small`."""
    sd: StateDict = {}
    for key, value in efficientnet_state_dict_from_jax(params["backbone"], cfg.backbone).items():
        old, new = next((old, new) for old, new in _LITE_REGROUP if key.startswith(old))
        sd[new + key[len(old):]] = value
    _midas_scratch(params, "layer{1}_rn", "out_conv{}", sd)
    return sd
