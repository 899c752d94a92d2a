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
adabins_depth.py, midas_depth.py, slip.py, blip.py, cloob.py, lit.py,
ruclip.py, super_resolution.py, owlvit.py and glide_clip.py; the deep image
prior has no JAX converter, its names are flax's; ruDALL-E's VQGAN is the
SD VAE's diffusers names plus taming's `quantize.*`):

    conv   (kh, kw, I, O) -> (O, I, kh, kw)
    dense  (I, O)         -> (O, I)      (ADM's 1x1 conv1d: (O, I, 1))
    norm   scale          -> weight

The port's keys are diffusers' (UNet, VAE, the VQ stage's backbone),
open_clip's (CLIP, both image towers), OpenAI guided_diffusion's (ADM;
CompVis's for its spatial transformers), k-diffusion's (MonsterDiffusion)
x-transformer's (BERT), torchvision's (the VGG, AlexNet, SqueezeNet and
ResNet trunks), lpips' (its heads), ResMem's, gen-efficientnet's, the
AdaBins repository's, MiDaS's (timm's ViT inside), SLIP's, BLIP's (timm
and HF-BERT), cloob-training's, LiT's, basicsr's (Real-ESRGAN), HF
OWL-ViT's, GLIDE's and StyleGAN-XL's, so the JAX package's
own `unet_from_diffusers`, `vae_from_diffusers`, `from_openclip`, the three
`from_torch`, `convert_bert`, `convert_torchvision_features`,
`convert_resnet`, `convert_resmem`, `convert_efficientnet`,
`convert_adabins`, `convert_dpt`, `convert_midas_net`,
`convert_midas_net_small`, `convert_slip`, `convert_blip`, `convert_cloob`,
`convert_lit`, `convert_rrdbnet`, `convert_srvgg`,
`convert_unet_discriminator`, `convert_owlvit`, `convert_glide_text`,
`convert_glide_image` and `convert_stylegan_xl` map these state_dicts back to the same trees.

Two maps are torch to torch: `open_clip_state_dict_from_hf` takes an HF
`transformers` CLIPModel state_dict to the port's open_clip names, and
`text_encoder_state_dict_from_hf` SD's HF text encoder to the port's.

The converter CLI (`main`) turns a checkpoint into the port's own artifact:

    python -m perceptor_tpu_torch.convert INPUT --family stable-diffusion \
        [--name runwayml/stable-diffusion-v1-5] [--out PATH] [--device cpu]

It builds the family's wrapper (fp32, past its memo) over INPUT staged in a
private cache directory under the name the wrapper searches for, so the
wrapper's own discovery reads it (any layout it reads: JAX's params-v1, a
CompVis, diffusers, open_clip or HF file), and writes the wrapper's state
dicts with `utils.checkpoints.save_port_artifact`, by default to
`models/<canonical basename>.torch.pt`. The next construction of that
wrapper finds the file and loads it with no key map. The JAX package never
finds it: its wrappers search the same directories, but only under a name
as it stands or with one of their suffixes (`.pt`, `.npz`, ...), never
`.torch.pt`. Families and default names are the JAX CLI's
(perceptor_tpu/convert.py).
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import sys
import tempfile
from typing import Dict, Mapping

import numpy as np
import torch

from perceptor_tpu_torch.models.adabins_depth import AdaBinsConfig, EfficientNetConfig
from perceptor_tpu_torch.models.blip import BLIPConfig
from perceptor_tpu_torch.models.clip.configs import CLIPConfig
from perceptor_tpu_torch.models.cloob import CLOOBConfig
from perceptor_tpu_torch.models.glide_clip import GlideCLIPConfig
from perceptor_tpu_torch.models.guided_diffusion.config import ADMConfig
from perceptor_tpu_torch.models.latent_diffusion.bert import BERTConfig
from perceptor_tpu_torch.models.lit import LiTConfig
from perceptor_tpu_torch.models.midas_depth import DPTConfig, MidasNetConfig, MidasNetSmallConfig
from perceptor_tpu_torch.models.monster_diffusion.net import MonsterConfig
from perceptor_tpu_torch.models.owlvit import OWLViTConfig
from perceptor_tpu_torch.models.slip import SLIPConfig
from perceptor_tpu_torch.models.stable_diffusion.config import TextConfig, UNetConfig, VAEConfig
from perceptor_tpu_torch.models.stylegan_xl import params_state_dict
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


def _clip_text(text: Mapping, layers: int, sd: StateDict) -> None:
    """Flax CLIP `TextTransformer` params -> open_clip's top-level names."""
    sd["token_embedding.weight"] = _t(text["token_embedding"])
    sd["positional_embedding"] = _t(text["positional_embedding"])
    sd["text_projection"] = _t(text["text_projection"])
    _norm(text["ln_final"], "ln_final", sd)
    _transformer(text["transformer"], "transformer", layers, sd)


def clip_state_dict_from_jax(params: Mapping, cfg: CLIPConfig) -> StateDict:
    """Flax `CLIP` params ({"visual", "text", "logit_scale"}) -> the port's
    open_clip-named state_dict: `visual.*`, the text tower at the top level
    and `logit_scale`."""
    sd = clip_visual_state_dict_from_jax(params["visual"], cfg)
    _clip_text(params["text"], cfg.text_layers, sd)
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


def text_encoder_state_dict_from_hf(hf_state_dict: Mapping, cfg: TextConfig,
                                    prefix: str = "text_model") -> StateDict:
    """An HF CLIPTextModel state_dict (SD's text encoder, under `prefix`) ->
    the port's `CLIPTextEncoder` (open_clip names). For a config with a
    `projection_dim` (SDXL's second tower, an HF
    `CLIPTextModelWithProjection`), the linear `text_projection.weight`
    (proj, width) beside `prefix` becomes open_clip's (width, proj)
    `text_projection`."""
    hf = hf_state_dict
    sd: StateDict = {
        "token_embedding.weight": torch.as_tensor(hf[f"{prefix}.embeddings.token_embedding.weight"]),
        "positional_embedding": torch.as_tensor(
            hf[f"{prefix}.embeddings.position_embedding.weight"]),
        "ln_final.weight": torch.as_tensor(hf[f"{prefix}.final_layer_norm.weight"]),
        "ln_final.bias": torch.as_tensor(hf[f"{prefix}.final_layer_norm.bias"]),
    }
    _hf_blocks(hf, f"{prefix}.encoder.layers", "transformer.resblocks", cfg.layers, sd)
    if cfg.projection_dim:
        sd["text_projection"] = torch.as_tensor(hf["text_projection.weight"]).t().contiguous()
    return sd


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


def _timm_blocks(p: Mapping, prefix: str, layers: int, sd: StateDict) -> None:
    """Flax timm-ViT blocks (`norm1_{i}`, `qkv_{i}`, ...) -> timm's
    `{prefix}.blocks.{i}.*`."""
    for i in range(layers):
        dst = f"{prefix}.blocks.{i}"
        for src, name in (("norm1", "norm1"), ("norm2", "norm2")):
            _norm(p[f"{src}_{i}"], f"{dst}.{name}", sd)
        for src, name in (("qkv", "attn.qkv"), ("attn_proj", "attn.proj"), ("fc1", "mlp.fc1"),
                          ("fc2", "mlp.fc2")):
            _linear(p[f"{src}_{i}"], f"{dst}.{name}", sd)


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
    _timm_blocks(backbone, m, cfg.vit_layers, sd)
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


# -- the CLIP family (SLIP, BLIP, CLOOB, LiT, RuCLIP) and deep image prior --


def _timm_vit(visual: Mapping, prefix: str, layers: int, sd: StateDict) -> None:
    """Flax `TimmViT` params -> timm's names under `prefix`."""
    _conv(visual["patch_embed"], f"{prefix}.patch_embed.proj", sd)
    sd[f"{prefix}.cls_token"] = _t(visual["cls_token"])
    sd[f"{prefix}.pos_embed"] = _t(visual["pos_embed"])
    _norm(visual["norm"], f"{prefix}.norm", sd)
    _timm_blocks(visual, prefix, layers, sd)


def _bert(text: Mapping, prefix: str, layers: int, sd: StateDict) -> None:
    """Flax `BertTextEncoder` params -> HF-BERT's names under `prefix`."""
    sd[f"{prefix}.embeddings.word_embeddings.weight"] = _t(text["word_embeddings"])
    sd[f"{prefix}.embeddings.position_embeddings.weight"] = _t(text["position_embeddings"])
    _norm(text["embeddings_norm"], f"{prefix}.embeddings.LayerNorm", sd)
    for i in range(layers):
        layer = f"{prefix}.encoder.layer.{i}"
        for src, name in (("q", "attention.self.query"), ("k", "attention.self.key"),
                          ("v", "attention.self.value"), ("attn_out", "attention.output.dense"),
                          ("ff_in", "intermediate.dense"), ("ff_out", "output.dense")):
            _linear(text[f"{src}_{i}"], f"{layer}.{name}", sd)
        _norm(text[f"attn_norm_{i}"], f"{layer}.attention.output.LayerNorm", sd)
        _norm(text[f"ff_norm_{i}"], f"{layer}.output.LayerNorm", sd)


def slip_state_dict_from_jax(params: Mapping, cfg: SLIPConfig) -> StateDict:
    """The JAX `SLIP` wrapper's params ({visual, image_projection, text}) ->
    `models/slip.py SLIPModule`'s names; the inverse of `convert_slip`."""
    sd: StateDict = {"image_projection": _t(params["image_projection"])}
    _timm_vit(params["visual"], "visual", cfg.vision_layers, sd)
    _clip_text(params["text"], cfg.text_layers, sd)
    return sd


def blip_state_dict_from_jax(params: Mapping, cfg: BLIPConfig) -> StateDict:
    """The JAX `BLIP` wrapper's params ({visual, text, vision_proj,
    text_proj}) -> `models/blip.py BLIPModule`'s names; the inverse of
    `convert_blip`."""
    sd: StateDict = {}
    _timm_vit(params["visual"], "visual_encoder", cfg.vision_layers, sd)
    _bert(params["text"], "text_encoder", cfg.text_layers, sd)
    _linear(params["vision_proj"], "vision_proj", sd)
    _linear(params["text_proj"], "text_proj", sd)
    return sd


def _cloob_layers(tower: Mapping, prefix: str, layers: int, sd: StateDict) -> None:
    for i in range(layers):
        p, dst = tower[f"layer_{i}"], f"{prefix}.layers.{i}"
        _norm(p["attn_norm"], f"{dst}.attn.norm", sd)
        for name in ("query", "key", "value", "out"):
            _linear(p[name], f"{dst}.attn.{name}", sd)
        _norm(p["ff_norm"], f"{dst}.ff.norm", sd)
        _linear(p["linear_0"], f"{dst}.ff.linear_0", sd)
        _linear(p["linear_1"], f"{dst}.ff.linear_1", sd)


def cloob_state_dict_from_jax(params: Mapping, cfg: CLOOBConfig) -> StateDict:
    """The JAX `CLOOB` wrapper's params ({image, text}) -> cloob-training's
    model_pt names (`models/cloob.py CLOOBModule`); the inverse of
    `convert_cloob`."""
    image, text = params["image"], params["text"]
    sd: StateDict = {}
    _conv(image["embed"], "image_encoder.embed", sd)
    sd["image_encoder.class_embed"] = _t(image["class_embed"])
    sd["image_encoder.pos_embed.weight"] = _t(image["pos_embed"])
    _linear(image["proj"], "image_encoder.proj", sd)
    _cloob_layers(image, "image_encoder", cfg.vision_layers, sd)
    sd["text_encoder.embed.weight"] = _t(text["embed"])
    sd["text_encoder.pos_embed.weight"] = _t(text["pos_embed"])
    _linear(text["proj"], "text_encoder.proj", sd)
    _cloob_layers(text, "text_encoder", cfg.text_layers, sd)
    return sd


def lit_state_dict_from_jax(params: Mapping, cfg: LiTConfig) -> StateDict:
    """The JAX `LiT` wrapper's params ({visual, text, text_head}) ->
    `models/lit.py LiTModule`'s names; the inverse of `convert_lit` (which
    folds a checkpoint's token-type embeddings into the word embeddings)."""
    sd: StateDict = {}
    _timm_vit(params["visual"], "image_tower", cfg.vision_layers, sd)
    _bert(params["text"], "text_tower", cfg.text_layers, sd)
    _linear(params["text_head"], "text_head", sd)
    return sd


# JAX's RuCLIP keeps no logit_scale (its encodings never read it); CLIP's
# initial value stands in
_LOGIT_SCALE_INIT = float(np.log(1 / 0.07))


def ruclip_state_dict_from_jax(params: Mapping, cfg: CLIPConfig) -> StateDict:
    """The JAX `RuCLIP` wrapper's params ({visual, text}) -> open_clip's
    names (`models/ruclip.py RuCLIPModule`); `from_openclip` maps them
    back."""
    sd = clip_visual_state_dict_from_jax(params["visual"], cfg)
    _clip_text(params["text"], cfg.text_layers, sd)
    sd["logit_scale"] = _t(params.get("logit_scale", _LOGIT_SCALE_INIT))
    return sd


def deep_image_prior_state_dict_from_jax(params: Mapping, prefix: str = "") -> StateDict:
    """A flax `SkipNet` param tree -> `models/deep_image_prior.py SkipNet`'s
    names, which are flax's: a conv's or deformable conv's `kernel` (HWIO)
    becomes its OIHW `weight`, a BatchNorm's `scale` its `weight`, nested
    `offset_conv` trees a submodule. `prefix` is put before every name (the
    drawer's `model.module.`)."""
    sd: StateDict = {}
    for name, value in params.items():
        if isinstance(value, Mapping):
            sd.update(deep_image_prior_state_dict_from_jax(value, f"{prefix}{name}."))
        elif name == "kernel":
            sd[f"{prefix}weight"] = _t(np.asarray(value).transpose(3, 2, 0, 1))
        else:
            sd[f"{prefix}{'weight' if name == 'scale' else name}"] = _t(value)
    return sd


# -- ruDALL-E's VQGAN, Real-ESRGAN, OWL-ViT and GLIDE's CLIP --


def rudalle_state_dict_from_jax(params: Mapping, cfg: VAEConfig) -> StateDict:
    """The JAX `GumbelVQGAN` params ({encoder, decoder, quant_conv,
    post_quant_conv, proj, embed}) -> `drawers/rudalle.py GumbelVQGAN`'s
    names: the VAE's diffusers names, `quantize.proj` and the codebook
    `quantize.embed.weight`."""
    sd = vae_state_dict_from_jax(params, cfg)
    _conv(params["proj"], "quantize.proj", sd)
    sd["quantize.embed.weight"] = _t(params["embed"])
    return sd


def rrdbnet_state_dict_from_jax(params: Mapping) -> StateDict:
    """Flax `RRDBNet` params -> basicsr's RRDBNet names (`body_{i}` becomes
    `body.{i}`); the inverse of `convert_rrdbnet`."""
    sd: StateDict = {}
    for name, value in params.items():
        if name.startswith("body_"):
            for rdb, convs in value.items():
                for conv, p in convs.items():
                    _conv(p, f"body.{name[len('body_'):]}.{rdb}.{conv}", sd)
        else:
            _conv(value, name, sd)
    return sd


def srvgg_state_dict_from_jax(params: Mapping, num_conv: int) -> StateDict:
    """Flax `SRVGGNetCompact` params -> basicsr's `body.{k}` list: conv
    `body_{i}` at 2 i, PReLU `prelu_{i}` at 2 i + 1, `body_last` at
    2 num_conv + 2; the inverse of `convert_srvgg`."""
    sd: StateDict = {}
    for i in range(num_conv + 1):
        _conv(params[f"body_{i}"], f"body.{2 * i}", sd)
        sd[f"body.{2 * i + 1}.weight"] = _t(params[f"prelu_{i}"])
    _conv(params["body_last"], f"body.{2 * num_conv + 2}", sd)
    return sd


def unet_discriminator_state_dict_from_jax(params: Mapping) -> StateDict:
    """Flax `UNetDiscriminatorSN` params (spectral norm folded) -> the port's
    plain `conv{i}` names; `convert_unet_discriminator` reads them back."""
    sd: StateDict = {}
    for name, p in params.items():
        _conv(p, name, sd)
    return sd


def _owlvit_layers(tower: Mapping, prefix: str, layers: int, sd: StateDict) -> None:
    for i in range(layers):
        p, dst = tower[f"layer_{i}"], f"{prefix}.encoder.layers.{i}"
        _norm(p["layer_norm1"], f"{dst}.layer_norm1", sd)
        _norm(p["layer_norm2"], f"{dst}.layer_norm2", sd)
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(p[name], f"{dst}.self_attn.{name}", sd)
        _linear(p["fc1"], f"{dst}.mlp.fc1", sd)
        _linear(p["fc2"], f"{dst}.mlp.fc2", sd)


def owlvit_state_dict_from_jax(params: Mapping, cfg: OWLViTConfig) -> StateDict:
    """The JAX `OWLViTDetection` params ({vision, text, merge_norm, the
    heads' denses}) -> HF `OwlViTForObjectDetection`'s names
    (`models/owlvit.py`); the inverse of `convert_owlvit`."""
    vision, text = params["vision"], params["text"]
    vp, tp = "owlvit.vision_model", "owlvit.text_model"
    sd: StateDict = {}
    _conv(vision["patch_embedding"], f"{vp}.embeddings.patch_embedding", sd)
    sd[f"{vp}.embeddings.class_embedding"] = _t(vision["class_embedding"])
    sd[f"{vp}.embeddings.position_embedding.weight"] = _t(vision["position_embedding"])
    _norm(vision["pre_layernorm"], f"{vp}.pre_layernorm", sd)
    _norm(vision["post_layernorm"], f"{vp}.post_layernorm", sd)
    _owlvit_layers(vision, vp, cfg.vision_layers, sd)
    sd[f"{tp}.embeddings.token_embedding.weight"] = _t(text["token_embedding"])
    sd[f"{tp}.embeddings.position_embedding.weight"] = _t(text["position_embedding"])
    _norm(text["final_layer_norm"], f"{tp}.final_layer_norm", sd)
    _owlvit_layers(text, tp, cfg.text_layers, sd)
    _linear(text["text_projection"], "owlvit.text_projection", sd)
    _norm(params["merge_norm"], "layer_norm", sd)
    for src, dst in (("class_dense0", "class_head.dense0"), ("logit_shift", "class_head.logit_shift"),
                     ("logit_scale", "class_head.logit_scale"), ("box_dense0", "box_head.dense0"),
                     ("box_dense1", "box_head.dense1"), ("box_dense2", "box_head.dense2")):
        _linear(params[src], dst, sd)
    return sd


def _glide_affine(p: Mapping, prefix: str, sd: StateDict) -> None:
    sd[f"{prefix}.w"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{prefix}.b"] = _t(p["bias"])


def _glide_ln(p: Mapping, prefix: str, sd: StateDict) -> None:
    sd[f"{prefix}.g"] = _t(p["scale"])
    sd[f"{prefix}.b"] = _t(p["bias"])


def _glide_tower(p: Mapping, n_blocks: int, sd: StateDict) -> None:
    for i in range(n_blocks):
        bp, dst = p[f"block_{i}"], f"blocks.block_{i}"
        _glide_ln(bp["attn_ln"], f"{dst}.f_attn.ln", sd)
        for name in ("f_q", "f_k", "f_v", "f_c"):
            _glide_affine(bp[name], f"{dst}.f_attn.{name}", sd)
        _glide_ln(bp["mlp_ln"], f"{dst}.f_mlp.ln", sd)
        _glide_affine(bp["f_1"], f"{dst}.f_mlp.f_1", sd)
        _glide_affine(bp["f_2"], f"{dst}.f_mlp.f_2", sd)
    _glide_ln(p["out_ln"], "blocks.output.ln", sd)
    _glide_affine(p["out_proj"], "blocks.output.f", sd)


def glide_clip_state_dict_from_jax(params: Mapping, cfg: GlideCLIPConfig) -> Dict[str, StateDict]:
    """The JAX `GlideCLIP.params` tree ({"text", "image"}) -> GLIDE's two
    state_dicts under the same keys, as `GlideCLIP.load_state_dicts` takes
    them; the inverse of `convert_glide_text` / `convert_glide_image`."""
    text, image = params["text"], params["image"]
    text_sd: StateDict = {"blocks.input.w_voc": _t(text["w_voc"]),
                          "blocks.input.w_pos": _t(text["w_pos"])}
    _glide_tower(text, cfg.text_blocks, text_sd)
    image_sd: StateDict = {
        "blocks.input.patch_proj": _t(np.asarray(image["patch_proj"]["kernel"]).transpose(3, 2, 0, 1)),
        "blocks.input.w_pos": _t(image["w_pos"]),
        "blocks.input.w_t": _t(image["w_t"]),
    }
    _glide_ln(image["embed_ln"], "blocks.input.ln", image_sd)
    _glide_tower(image, cfg.image_blocks, image_sd)
    return {"text": text_sd, "image": image_sd}


def stylegan_xl_state_dict_from_jax(params: Mapping, cfg) -> StateDict:
    """The JAX `StyleGANXLGenerator` params ({input, L*, mapping}) under
    `GeneratorConfig` `cfg` -> the port generator's state_dict, the designed
    filters included; the inverse of `convert_stylegan_xl`. The map lives
    beside the model, whose random init loads through it."""
    return params_state_dict(params, cfg)


# -- the converter CLI -------------------------------------------------------

FAMILIES = (
    "stable-diffusion",
    "guided-diffusion",
    "velocity-diffusion",
    "monster-diffusion",
    "latent-text2image",
    "latent-face",
    "latent-super-resolution",
    "open-clip",
    "simulacra-aesthetic",
)

DEFAULT_NAMES = {
    "stable-diffusion": "runwayml/stable-diffusion-v1-5",
    "guided-diffusion": "standard",
    "velocity-diffusion": "yfcc_2",
    "monster-diffusion": "all",
    "latent-text2image": "txt2img-1p4B",
    "latent-face": "celebahq-ldm-vq-4",
    "latent-super-resolution": "sharpen-colab",
    "open-clip": "ViT-B-32/openai",
    "simulacra-aesthetic": "ViT-B-32",
}


def canonical_basename(family: str, name: str) -> str:
    """The first name the family's wrapper asks `find_checkpoint` for."""
    if family == "stable-diffusion":
        return f"stable_diffusion_{name.replace('/', '_')}"
    if family in ("guided-diffusion", "velocity-diffusion", "monster-diffusion"):
        return f"{family.replace('-', '_')}_{name}"
    if family == "latent-text2image":
        return "latent_diffusion_text2image"
    if family == "latent-face":
        return "latent_diffusion_face"
    if family == "latent-super-resolution":
        return "latent_diffusion_super_resolution"
    if family == "open-clip":
        arch, _, weights = name.partition("/")
        return f"open_clip_{arch}_{weights}"
    if family == "simulacra-aesthetic":
        return f"simulacra_{name}"
    raise ValueError(f"unknown family {family!r}; choose from {FAMILIES}")


def _fresh(cls, *args, **kwargs):
    """`cls(*args, **kwargs)` past the `utils.cache` memo: a memoized
    instance would hold the weights it had before the staged file."""
    return getattr(cls, "__wrapped__", cls)(*args, **kwargs)


def _construct(family: str, name: str, device):
    """The family's wrapper in fp32 (the artifact keeps fp32 masters; a bf16
    wrapper casts on load)."""
    from perceptor_tpu_torch import models

    if family == "stable-diffusion":
        return _fresh(models.StableDiffusion, name, fp16=False, device=device)
    if family == "guided-diffusion":
        return _fresh(models.GuidedDiffusion, name, fp16=False, device=device)
    if family == "velocity-diffusion":
        return _fresh(models.VelocityDiffusion, name, fp16=False, device=device)
    if family == "monster-diffusion":
        return _fresh(models.MonsterDiffusion, name, fp16=False, device=device)
    if family in ("latent-text2image", "latent-face", "latent-super-resolution"):
        from perceptor_tpu_torch.models import latent_diffusion

        cls = {"latent-text2image": latent_diffusion.Text2Image,
               "latent-face": latent_diffusion.Face,
               "latent-super-resolution": latent_diffusion.SuperResolution}[family]
        return _fresh(cls, fp16=False, device=device)
    if family == "open-clip":
        arch, _, weights = name.partition("/")
        return _fresh(models.OpenCLIP, arch, weights, precision="fp32", device=device)
    if family == "simulacra-aesthetic":
        return _fresh(models.SimulacraAesthetic, name, precision="fp32", device=device)
    raise ValueError(f"unknown family {family!r}; choose from {FAMILIES}")


def convert(input_path: str, family: str, name: str, out: str, device="cuda") -> str:
    """Convert `input_path` into the port's artifact at `out` (the
    `.torch.pt` suffix appended when missing); returns the path written."""
    from perceptor_tpu_torch.utils import checkpoints

    if not os.path.exists(input_path):
        raise FileNotFoundError(input_path)
    suffix = os.path.splitext(input_path)[1] or ".pt"
    staging = tempfile.mkdtemp(prefix="perceptor_tpu_torch_convert_")
    try:
        staged = os.path.join(staging, canonical_basename(family, name) + suffix)
        os.symlink(os.path.abspath(input_path), staged)
        original_dirs = checkpoints.CACHE_DIRS
        checkpoints.CACHE_DIRS = (staging,)
        try:
            wrapper = _construct(family, name, device)
        finally:
            checkpoints.CACHE_DIRS = original_dirs
        return checkpoints.save_port_artifact(out, wrapper.serving_modules())
    finally:
        shutil.rmtree(staging, ignore_errors=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m perceptor_tpu_torch.convert", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("input", help="checkpoint to convert")
    parser.add_argument("--family", required=True, choices=FAMILIES)
    parser.add_argument("--name", default=None,
                        help="name within the family (default: the family's flagship)")
    parser.add_argument("--out", default=None,
                        help="artifact path (default: models/<canonical>.torch.pt)")
    parser.add_argument("--device", default="cuda",
                        help="where the wrapper is built (default: cuda)")
    args = parser.parse_args(argv)
    name = args.name or DEFAULT_NAMES[args.family]
    from perceptor_tpu_torch.utils.checkpoints import PORT_SUFFIX

    out = args.out or os.path.join("models", canonical_basename(args.family, name) + PORT_SUFFIX)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    print(f"wrote {convert(args.input, args.family, name, out, args.device)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
