"""The port's HF-layout CLIP (`models/transformers_openai_clip.py`, its loss
and `convert.open_clip_state_dict_from_hf`), the Simulacra aesthetic probe
and the AVA head against the JAX package at a tiny ViT width, on the CPU,
on the same weights (a synthetic HF state dict, or flax params re-drawn from
a seeded numpy rng) and the same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import perceptor_tpu.models as jmodels
from perceptor_tpu import losses as jlosses
from perceptor_tpu.losses import simulacra_aesthetic as jsimulacra_loss
from perceptor_tpu.losses.prompt_bank import PromptBankLoss as JPromptBankLoss
from perceptor_tpu.models import transformers_openai_clip as jtoc
from perceptor_tpu.models.clip import convert as jclip_convert
from perceptor_tpu.models.clip.configs import CLIPConfig as JCLIPConfig
from perceptor_tpu.models.clip.model import CLIP as JCLIP
from perceptor_tpu.models.open_clip import OpenCLIP as JOpenCLIP
from perceptor_tpu.models.simulacra_aesthetic import SimulacraAesthetic as JSimulacra
from perceptor_tpu_torch import convert, losses, models
from perceptor_tpu_torch.models.clip.configs import CLIPConfig, get_config
from perceptor_tpu_torch.models.clip.model import CLIP
from perceptor_tpu_torch.models.transformers_openai_clip import NAME_TO_ARCH

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)

# fp32 towers on both sides through two transformer layers: embeddings and
# ratings to the ATOL of test_torch_clip_text.py, loss values relative,
# image gradients to GRAD_RTOL of their largest magnitude
ATOL = 1e-5
RTOL = 1e-5
GRAD_RTOL = 1e-4
# bf16 towers on both sides, relative L2 of the embeddings: each package
# rounds activations to bf16 at its own points (7 mantissa bits, ~4e-3 a
# rounding), so the two drift apart by a few roundings
BF16_RTOL_L2 = 2e-2

# a ViT of widths 24 / 20 with the real vocabulary and context, for the
# tokenizer; embed 16
TINY = dict(
    embed_dim=16, image_size=(32, 32), patch_size=8, vision_width=24, vision_layers=2,
    vision_heads=2, context_length=77, vocab_size=49408, text_width=20, text_layers=2,
    text_heads=2, quick_gelu=True,
)
PROMPTS = ["a photograph of a lighthouse", "an oil painting of a cat"]


def _hf_state_dict(cfg: JCLIPConfig, seed: int):
    """A synthetic HF `CLIPModel` state dict at `cfg` (numpy, seeded), with
    the `position_ids` buffers HF checkpoints carry."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-1])).astype(np.float32)

    def b(*shape):
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    def ln(*shape):
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)

    grid = cfg.image_size[0] // cfg.patch_size
    sd = {
        "vision_model.embeddings.patch_embedding.weight":
            w(cfg.vision_width, 3, cfg.patch_size, cfg.patch_size),
        "vision_model.embeddings.class_embedding": b(cfg.vision_width),
        "vision_model.embeddings.position_embedding.weight": b(grid * grid + 1, cfg.vision_width),
        "vision_model.embeddings.position_ids": np.arange(grid * grid + 1)[None],
        "vision_model.pre_layrnorm.weight": ln(cfg.vision_width),
        "vision_model.pre_layrnorm.bias": b(cfg.vision_width),
        "vision_model.post_layernorm.weight": ln(cfg.vision_width),
        "vision_model.post_layernorm.bias": b(cfg.vision_width),
        "visual_projection.weight": w(cfg.embed_dim, cfg.vision_width),
        "text_model.embeddings.token_embedding.weight": b(cfg.vocab_size, cfg.text_width),
        "text_model.embeddings.position_embedding.weight": b(cfg.context_length, cfg.text_width),
        "text_model.embeddings.position_ids": np.arange(cfg.context_length)[None],
        "text_model.final_layer_norm.weight": ln(cfg.text_width),
        "text_model.final_layer_norm.bias": b(cfg.text_width),
        "text_projection.weight": w(cfg.embed_dim, cfg.text_width),
        "logit_scale": np.array(2.6592, np.float32),
    }
    for tower, width, layers in (("vision_model", cfg.vision_width, cfg.vision_layers),
                                 ("text_model", cfg.text_width, cfg.text_layers)):
        for i in range(layers):
            p = f"{tower}.encoder.layers.{i}"
            for name in ("layer_norm1", "layer_norm2"):
                sd[f"{p}.{name}.weight"], sd[f"{p}.{name}.bias"] = ln(width), b(width)
            for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
                sd[f"{p}.self_attn.{name}.weight"] = w(width, width)
                sd[f"{p}.self_attn.{name}.bias"] = b(width)
            sd[f"{p}.mlp.fc1.weight"], sd[f"{p}.mlp.fc1.bias"] = w(4 * width, width), b(4 * width)
            sd[f"{p}.mlp.fc2.weight"], sd[f"{p}.mlp.fc2.bias"] = w(width, 4 * width), b(width)
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _images(seed, shape=(2, 3, 40, 36)):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol)


def _close_grad(got, want):
    want = np.asarray(want)
    assert float(np.abs(np.asarray(got) - want).max()) <= GRAD_RTOL * float(np.abs(want).max())


@pytest.fixture(scope="module")
def hf():
    jcfg = JCLIPConfig(**TINY)
    return jcfg, _hf_state_dict(jcfg, seed=0)


def test_open_clip_state_dict_from_hf_matches_jax_from_hf(hf):
    """Key for key, the port's map equals the JAX `from_hf` tree carried
    across by `clip_state_dict_from_jax`; both towers then agree with JAX's
    on that tree."""
    jcfg, hf_sd = hf
    cfg = CLIPConfig(**TINY)
    params = jclip_convert.from_hf(hf_sd, jcfg)
    sd = convert.open_clip_state_dict_from_hf(hf_sd, cfg)
    want_sd = convert.clip_state_dict_from_jax(params, cfg)
    assert set(sd) == set(want_sd) and not any("position_ids" in k for k in sd)
    for key, value in want_sd.items():
        np.testing.assert_array_equal(sd[key].numpy(), value.numpy(), err_msg=key)
    module = CLIP(cfg).eval()
    module.load_state_dict(sd)
    images = _images(1, (2, 3, 32, 32))
    tokens = np.zeros((2, 77), np.int64)
    tokens[:, :4] = [[49406, 320, 1125, 49407], [49406, 530, 2368, 49407]]
    apply = jax.jit(lambda p, x, t: (
        JCLIP(jcfg).apply({"params": p}, x, method=JCLIP.encode_image),
        JCLIP(jcfg).apply({"params": p}, t, method=JCLIP.encode_text)))
    want_img, want_txt = apply(params, jnp.asarray(images), jnp.asarray(tokens))
    with torch.no_grad():
        _close(module.encode_image(torch.from_numpy(images)).numpy(), want_img)
        _close(module.encode_text(torch.from_numpy(tokens)).numpy(), want_txt)


def test_hf_map_refuses_a_resnet_config():
    with pytest.raises(ValueError, match="ViT towers only"):
        convert.open_clip_state_dict_from_hf({}, get_config("RN50", "openai"))


def test_transformers_clip_draws_models_clip_weights():
    """Same architecture and seed: the same random weights as
    `models.CLIP`, in a tower of its own."""
    cfg = CLIPConfig(**TINY)
    hf_clip = models.TransformersOpenAICLIP("openai/clip-vit-base-patch32", config=cfg,
                                            device="cpu", seed=3)
    clip = models.CLIP("ViT-B-32", config=cfg, device="cpu", seed=3)
    assert hf_clip.architecture == clip.architecture == "ViT-B-32-quickgelu"
    assert hf_clip.module is not clip.module
    assert hf_clip.module.visual.proj.dtype == torch.bfloat16
    want = clip.module.state_dict()
    got = hf_clip.module.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    assert models.TransformersOpenAICLIP("openai/clip-vit-base-patch32", config=cfg,
                                         device="cpu", seed=3) is hf_clip
    with pytest.raises(ValueError, match="unknown transformers clip model"):
        models.TransformersOpenAICLIP("M-CLIP/XLM-Roberta-Large-Vit-B-32", device="cpu")
    assert NAME_TO_ARCH == jtoc.NAME_TO_ARCH


@pytest.mark.parametrize("size", [(32, 32), (40, 36)], ids=["native", "resized"])
def test_transformers_clip_loss_matches_jax(hf, size):
    """`losses.TransformersOpenAICLIP` in fp32 with HF weights loaded: text
    prompts through the real tokenizer, the loss and its image gradient
    against JAX's prompt bank over the same tower (the reference's own
    parity: the HF wrapper computes what OpenCLIP does on those weights)."""
    jcfg, hf_sd = hf
    jmodel = JOpenCLIP("ViT-B-32", "torch-port-aesthetic-hf", precision="fp32", config=jcfg)
    jmodel.params = jclip_convert.from_hf(hf_sd, jcfg)
    jloss = JPromptBankLoss(jmodel).add_texts_(PROMPTS)
    loss = losses.TransformersOpenAICLIP("openai/clip-vit-base-patch32", config=CLIPConfig(**TINY),
                                         precision="fp32", device="cpu", seed=1)
    loss.model.load_state_dict(hf_sd)
    loss.add_texts_(PROMPTS)
    assert loss.name == "openai/clip-vit-base-patch32"
    images = _images(2, (2, 3, *size))
    x = torch.from_numpy(images).requires_grad_(True)
    value = loss(x)
    (grad,) = torch.autograd.grad(value, x)
    want, want_grad = jax.jit(jax.value_and_grad(lambda im: jloss(im)))(jnp.asarray(images))
    np.testing.assert_allclose(float(value.detach()), float(want), rtol=RTOL)
    _close_grad(grad.numpy(), want_grad)


def test_transformers_clip_bf16_matches_jax_bf16(hf, monkeypatch):
    """The bf16 wrapper on HF weights against the JAX package's bf16
    `TransformersOpenAICLIP` built at the tiny config."""
    jcfg, hf_sd = hf
    monkeypatch.setattr(jtoc.clip_configs, "get_config", lambda arch, weights: jcfg)
    jmodel = jtoc.TransformersOpenAICLIP.__wrapped__("openai/clip-vit-base-patch32")
    jmodel.params = jclip_convert.from_hf(hf_sd, jcfg)
    model = models.TransformersOpenAICLIP("openai/clip-vit-base-patch32",
                                          config=CLIPConfig(**TINY), device="cpu", seed=2)
    model.load_state_dict(hf_sd)
    assert model.module.visual.proj.dtype == torch.bfloat16
    images = _images(3)
    want = np.asarray(jmodel.encode_images(jnp.asarray(images)), np.float32)
    with torch.no_grad():
        got = model.encode_images(torch.from_numpy(images)).float().numpy()
    assert np.linalg.norm(got - want) <= BF16_RTOL_L2 * np.linalg.norm(want)


def _random_clip_params(jcfg, seed):
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "scale":
            out = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        elif len(leaf.shape) >= 2:
            out = rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        else:
            out = 0.1 * rng.standard_normal(leaf.shape)
        return jnp.asarray(out.astype(np.float32))

    shapes = jax.eval_shape(
        JCLIP(jcfg).init, jax.random.PRNGKey(0), jnp.zeros((1, 3, *jcfg.image_size)),
        jnp.zeros((1, jcfg.context_length), jnp.int32),
    )["params"]
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def towers():
    """A tiny fp32 JAX CLIP of this file's own (its params re-drawn) and the
    port's `models.CLIP` keyword arguments for the same weights."""
    jcfg = JCLIPConfig(**TINY)
    params = _random_clip_params(jcfg, seed=4)
    jclip = JOpenCLIP("ViT-B-16", "torch-port-aesthetic", precision="fp32", config=jcfg)
    jclip.params = params
    state = convert.clip_state_dict_from_jax(params, CLIPConfig(**TINY))
    return jclip, state


@pytest.mark.parametrize("model_name,multiplier", [("ViT-B-32", 1e-3), ("ViT-L-14", 1e-5)])
def test_simulacra_matches_jax(towers, monkeypatch, model_name, multiplier):
    """The rating `normalize(e) * sqrt(D) @ w + b` over the same tower, the
    untrained probe as JAX draws it, the loss's multiplier and its image
    gradient."""
    jclip, state = towers
    monkeypatch.setattr(jmodels, "CLIP", lambda name, **kwargs: jclip)
    jmodel = JSimulacra.__wrapped__(model_name)
    monkeypatch.setattr(jsimulacra_loss, "Model", lambda name: jmodel)
    jloss = jlosses.SimulacraAesthetic(model_name, aesthetic_target=8)
    kwargs = dict(config=CLIPConfig(**TINY), precision="fp32", device="cpu", seed=5)
    clip = models.CLIP(model_name, **kwargs)  # held: the rating's memoized tower
    clip.load_state_dict(state)
    loss = losses.SimulacraAesthetic(model_name, aesthetic_target=8, **kwargs)
    assert loss.model.clip_model is clip and loss.multiplier == jloss.multiplier == multiplier
    np.testing.assert_array_equal(loss.model.weight.numpy(), np.asarray(jmodel.weight))
    images = _images(6)
    with torch.no_grad():
        rating = loss.model(torch.from_numpy(images))
    want_rating = jax.jit(jmodel.rating_fn)(jclip.params, jnp.asarray(images))
    assert rating.shape == (2, 1)
    _close(rating.numpy(), want_rating)
    x = torch.from_numpy(images).requires_grad_(True)
    value = loss(x)
    (grad,) = torch.autograd.grad(value, x)
    want, want_grad = jax.jit(jax.value_and_grad(jloss.forward))(jnp.asarray(images))
    np.testing.assert_allclose(float(value.detach()), float(want), rtol=RTOL)
    _close_grad(grad.numpy(), want_grad)


def test_simulacra_probe_loads_upstream_layout():
    kwargs = dict(config=CLIPConfig(**TINY), precision="fp32", device="cpu", seed=6)
    model = models.SimulacraAesthetic("ViT-B-32", **kwargs)
    weight = torch.arange(16, dtype=torch.float32)[None] / 16
    model.load_state_dict({"linear.weight": weight, "linear.bias": torch.tensor([0.5])})
    assert model.weight.shape == (16, 1) and float(model.bias) == 0.5
    with pytest.raises(ValueError, match=r"expected \(16, 1\)"):
        model.load_state_dict({"linear.weight": torch.zeros(1, 8), "linear.bias": torch.zeros(1)})


@pytest.mark.parametrize("mode", ["logit", "expected", "probability"])
def test_ava_matches_jax(towers, monkeypatch, mode):
    """The 10-way head over unnormalized ViT-B-16 embeddings (the untrained
    head as JAX draws it), each mode's value and image gradient."""
    jclip, state = towers
    monkeypatch.setattr(jmodels, "CLIP", lambda name, **kwargs: jclip)
    jloss = jlosses.AestheticVisualAssessment(aesthetic_target=7, mode=mode)
    kwargs = dict(config=CLIPConfig(**TINY), precision="fp32", device="cpu", seed=7)
    clip = models.CLIP("ViT-B-16", **kwargs)  # held: the loss's memoized tower
    clip.load_state_dict(state)
    loss = losses.AestheticVisualAssessment(aesthetic_target=7, mode=mode, **kwargs)
    assert loss.model is clip
    np.testing.assert_array_equal(loss.weight.numpy(), np.asarray(jloss.weight))
    images = _images(8)
    x = torch.from_numpy(images).requires_grad_(True)
    value = loss(x)
    (grad,) = torch.autograd.grad(value, x)
    want, want_grad = jax.jit(jax.value_and_grad(jloss.forward))(jnp.asarray(images))
    np.testing.assert_allclose(float(value.detach()), float(want), rtol=RTOL)
    _close_grad(grad.numpy(), want_grad)
    with pytest.raises(ValueError, match="Unknown mode"):
        losses.AestheticVisualAssessment(mode="bogus", **kwargs)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["ViT-B-32", "ViT-B-16"])
def test_full_width_simulacra_matches_jax(name):
    """At the published width: `SimulacraAesthetic(name)` on the JAX
    package's own random tower, carried across."""
    jmodel = JSimulacra.__wrapped__(name)
    kwargs = dict(precision="fp32", device="cpu", seed=8)
    clip = models.CLIP(name, **kwargs)
    clip.load_state_dict(convert.clip_state_dict_from_jax(jmodel.clip_model.params, clip.config))
    model = models.SimulacraAesthetic(name, **kwargs)
    images = _images(9, (1, 3, 64, 64))
    with torch.no_grad():
        got = model(torch.from_numpy(images)).numpy()
    want = np.asarray(jax.jit(jmodel.rating_fn)(jmodel.clip_model.params, jnp.asarray(images)))
    # JAX's tower is bf16 here, the port's fp32
    np.testing.assert_allclose(got, want, atol=5e-2 * float(np.abs(want).max()))


def test_aesthetic_wrappers_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    for make in (lambda: models.TransformersOpenAICLIP(), lambda: losses.SimulacraAesthetic(),
                 lambda: losses.AestheticVisualAssessment()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
