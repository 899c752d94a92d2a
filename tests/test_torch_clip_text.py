"""The port's CLIP text tower, whole `CLIP` module and `models.OpenCLIP`
wrapper against the JAX package at a tiny width, fp32 on the CPU, on the
same weights (flax params re-drawn from a seeded numpy rng and carried
across with `convert.clip_state_dict_from_jax`) and the same inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceptor_tpu.models.clip import convert as jclip_convert
from perceptor_tpu.models.clip.configs import CLIPConfig as JCLIPConfig
from perceptor_tpu.models.clip.model import CLIP as JCLIP
from perceptor_tpu.models.open_clip import OpenCLIP as JOpenCLIP
from perceptor_tpu_torch import convert, models
from perceptor_tpu_torch.models.clip.configs import CLIPConfig, get_config
from perceptor_tpu_torch.models.clip.model import CLIP, TextTransformer
from perceptor_tpu_torch.models.clip_alias import _QUICKGELU_FIXUP

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)

# fp32 on both sides through two transformer layers
ATOL = 1e-5

TINY = dict(
    embed_dim=16, image_size=(32, 32), patch_size=8, vision_width=24, vision_layers=2,
    vision_heads=2, context_length=12, vocab_size=64, text_width=20, text_layers=2,
    text_heads=2, quick_gelu=True,
)
# the real vocabulary and context over the tiny widths, for the tokenizer
REAL_VOCAB = dict(TINY, context_length=77, vocab_size=49408)


def _random_params(cfg: JCLIPConfig, seed):
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
        JCLIP(cfg).init, jax.random.PRNGKey(0), jnp.zeros((1, 3, *cfg.image_size)),
        jnp.zeros((1, cfg.context_length), jnp.int32),
    )["params"]
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _pair(quick_gelu=True, seed=0):
    jcfg = JCLIPConfig(**dict(TINY, quick_gelu=quick_gelu))
    params = _random_params(jcfg, seed)
    module = CLIP(CLIPConfig(**dict(TINY, quick_gelu=quick_gelu)))
    module.load_state_dict(convert.clip_state_dict_from_jax(params, jcfg))
    return jcfg, params, module.eval()


def _tokens(rng, n=3):
    """Rows <sot> words <eot> 0-padded, the eot (63) the largest id."""
    tokens = np.zeros((n, TINY["context_length"]), np.int64)
    for row in tokens:
        length = rng.integers(2, TINY["context_length"] - 1)
        row[0], row[1:length], row[length] = 62, rng.integers(1, 62, length - 1), 63
    return tokens


@pytest.mark.parametrize("quick_gelu", [True, False], ids=["quick_gelu", "exact_gelu"])
def test_text_tower_matches_jax(quick_gelu):
    jcfg, params, module = _pair(quick_gelu)
    tokens = _tokens(np.random.default_rng(1))
    want = JCLIP(jcfg).apply({"params": params}, jnp.asarray(tokens), method=JCLIP.encode_text)
    with torch.no_grad():
        got = module.encode_text(torch.from_numpy(tokens))
    assert got.shape == (3, TINY["embed_dim"]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # `text` is the tower as a callable
    with torch.no_grad():
        assert torch.equal(module.text(tokens), got)


def test_clip_both_towers_match_jax():
    jcfg, params, module = _pair()
    rng = np.random.default_rng(2)
    tokens = _tokens(rng)
    images = rng.standard_normal((3, 3, 32, 32)).astype(np.float32)
    j_img, j_txt, j_scale = JCLIP(jcfg).apply(
        {"params": params}, jnp.asarray(images), jnp.asarray(tokens)
    )
    with torch.no_grad():
        t_img, t_txt, t_scale = module(torch.from_numpy(images), torch.from_numpy(tokens))
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), atol=ATOL)
    np.testing.assert_allclose(t_txt.numpy(), np.asarray(j_txt), atol=ATOL)
    np.testing.assert_allclose(float(t_scale.detach()), float(j_scale), rtol=1e-7)


def test_state_dict_round_trip_through_from_openclip():
    jcfg, params, module = _pair()
    sd = {k: v.numpy() for k, v in module.state_dict().items()}
    back = jclip_convert.from_openclip(sd, jcfg)
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(got) == {path for path, _ in want}
    for path, leaf in want:
        np.testing.assert_allclose(np.asarray(got[path]), np.asarray(leaf), atol=1e-7,
                                   err_msg=str(path))


def test_text_tower_alone_has_open_clip_names():
    tower = TextTransformer(CLIPConfig(**TINY))
    names = set(tower.state_dict())
    assert {"token_embedding.weight", "positional_embedding", "ln_final.weight",
            "text_projection", "transformer.resblocks.1.attn.in_proj_weight"} <= names
    full = set(CLIP(CLIPConfig(**TINY)).state_dict())
    assert names < full and "logit_scale" in full and "visual.proj" in full
    # a seeded fill follows named_parameters(): the image tower first, whole
    order = [name for name, _ in CLIP(CLIPConfig(**TINY)).named_parameters()]
    n_visual = sum(name.startswith("visual.") for name in order)
    assert all(name.startswith("visual.") for name in order[:n_visual])
    assert sorted(order) == sorted(full) and len(set(order)) == len(order)


def test_out_of_range_token_ids_raise():
    _, _, module = _pair()
    tokens = _tokens(np.random.default_rng(3))
    for bad in (TINY["vocab_size"], -1):
        broken = tokens.copy()
        broken[0, 1] = bad
        with pytest.raises(ValueError, match="token ids must lie in"):
            module.encode_text(torch.from_numpy(broken))


def test_text_tower_pools_at_the_largest_id():
    """Under the causal mask nothing after the end-of-text token reaches the
    pooled position."""
    _, _, module = _pair()
    tokens = _tokens(np.random.default_rng(4), n=1)
    eot = int(tokens[0].argmax())
    assert eot < TINY["context_length"] - 1
    changed = tokens.copy()
    changed[0, eot + 1:] = 5
    with torch.no_grad():
        a, b = module.encode_text(tokens), module.encode_text(changed)
    assert torch.equal(a, b)
    moved = tokens.copy()
    moved[0, 1] = 7 if tokens[0, 1] != 7 else 8
    with torch.no_grad():
        assert not torch.allclose(module.encode_text(moved), a, atol=1e-4)


@pytest.fixture(scope="module")
def wrappers():
    """The JAX wrapper (its own random init) and the port's on its weights,
    real vocabulary, tiny widths, fp32."""
    jcfg = JCLIPConfig(**REAL_VOCAB)
    jmodel = JOpenCLIP("ViT-B-32", "torch-port-test", precision="fp32", config=jcfg)
    model = models.OpenCLIP("ViT-B-32", "torch-port-test", precision="fp32",
                            config=CLIPConfig(**REAL_VOCAB), device="cpu")
    model.load_state_dict(convert.clip_state_dict_from_jax(
        jax.tree.map(np.asarray, jmodel.params), jcfg))
    return jmodel, model


PROMPTS = ["a photograph of an astronaut riding a horse", "two dogs", ""]


def test_open_clip_encode_texts_matches_jax(wrappers):
    from perceptor_tpu.models.clip.tokenizer import tokenize as j_tokenize
    from perceptor_tpu_torch.models.clip.tokenizer import tokenize

    jmodel, model = wrappers
    np.testing.assert_array_equal(
        tokenize(PROMPTS, 77, tokenizer=model.tokenizer),
        j_tokenize(PROMPTS, 77, tokenizer=jmodel.tokenizer),
    )
    got = model.encode_texts(PROMPTS)
    assert got.shape == (3, TINY["embed_dim"]) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(jmodel.encode_texts(PROMPTS)), atol=ATOL)
    np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, atol=1e-6)
    raw = model.encode_texts(PROMPTS, normalize=False)
    np.testing.assert_allclose(
        raw.numpy(), np.asarray(jmodel.encode_texts(PROMPTS, normalize=False)), atol=ATOL)
    tokens = tokenize(PROMPTS, 77, tokenizer=model.tokenizer)
    assert torch.equal(model.encode_tokens(tokens), got)


@pytest.mark.parametrize("size", [(32, 32), (48, 40)], ids=["native", "resized"])
def test_open_clip_encode_images_matches_jax(wrappers, size):
    jmodel, model = wrappers
    images = np.random.default_rng(5).uniform(size=(2, 3, *size)).astype(np.float32)
    x = torch.from_numpy(images).requires_grad_(True)
    got = model.encode_images(x)
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(jmodel.encode_images(jnp.asarray(images))), atol=ATOL)
    probe = np.random.default_rng(6).standard_normal(got.shape).astype(np.float32)
    (grad,) = torch.autograd.grad((got * torch.from_numpy(probe)).sum(), x)
    want = jax.grad(lambda im: (jmodel.encode_images(im) * probe).sum())(jnp.asarray(images))
    assert np.abs(grad.numpy() - np.asarray(want)).max() <= 1e-4 * np.abs(want).max()
    assert model.image_size == (32, 32)


def test_spherical_distance_matches_jax(wrappers):
    jmodel, model = wrappers
    rng = np.random.default_rng(7)
    a, b = (rng.standard_normal((n, 16)).astype(np.float32) for n in (2, 3))
    a, b = (x / np.linalg.norm(x, axis=-1, keepdims=True) for x in (a, b))
    np.testing.assert_allclose(
        model.spherical_distance(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jmodel.spherical_distance(jnp.asarray(a), jnp.asarray(b))), atol=1e-6)


def test_wrapper_is_shared_per_arguments_and_keyed_on_device_and_seed():
    cfg = CLIPConfig(**TINY)
    a = models.OpenCLIP("ViT-B-32", "cache-test", config=cfg, device="cpu")
    assert models.OpenCLIP("ViT-B-32", "cache-test", config=cfg, device="cpu") is a
    other_seed = models.OpenCLIP("ViT-B-32", "cache-test", config=cfg, device="cpu", seed=1)
    assert other_seed is not a
    assert not torch.equal(other_seed.module.visual.proj, a.module.visual.proj)
    # seeded: the same seed gives the same weights in a fresh instance
    again = models.OpenCLIP("ViT-B-32", "cache-test-2", config=cfg, device="cpu")
    assert again is not a and torch.equal(again.module.visual.proj, a.module.visual.proj)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            models.OpenCLIP("ViT-B-32", "cache-test", config=cfg)


def test_wrapper_precision_and_frozen_towers():
    cfg = CLIPConfig(**TINY)
    bf16 = models.OpenCLIP("ViT-B-32", "precision-test", config=cfg, device="cpu")
    fp32 = models.OpenCLIP("ViT-B-32", "precision-test", precision="fp32", config=cfg,
                           device="cpu")
    assert bf16.module.visual.proj.dtype == torch.bfloat16
    assert bf16.module.token_embedding.weight.dtype == torch.bfloat16
    assert bf16.module.ln_final.weight.dtype == torch.float32
    assert fp32.module.visual.proj.dtype == torch.float32
    assert not any(p.requires_grad for p in bf16.module.parameters())
    images = torch.rand(1, 3, 32, 32)
    # bf16 matmuls against fp32 on the same (bf16-representable) weights
    fp32.load_state_dict({k: v.float() for k, v in bf16.module.state_dict().items()})
    err = (bf16.encode_images(images) - fp32.encode_images(images)).norm()
    assert float(err) <= 5e-2


def test_clip_alias_applies_the_quickgelu_fixup():
    cfg = CLIPConfig(**TINY)
    model = models.CLIP("ViT-B-32", config=cfg, device="cpu")
    assert (model.architecture, model.weights) == ("ViT-B-32-quickgelu", "openai")
    assert models.CLIP("ViT-H-14", config=cfg, device="cpu").architecture == "ViT-H-14"
    for name, fixed in _QUICKGELU_FIXUP.items():
        assert get_config(fixed, "openai").quick_gelu
        assert dataclasses.replace(get_config(fixed), quick_gelu=False) == dataclasses.replace(
            get_config(name), quick_gelu=False)
    from perceptor_tpu_torch.models.glide_clip import GlideCLIP

    from perceptor_tpu_torch.models.stylegan_xl import StyleGANXL

    assert models.GlideCLIP is GlideCLIP and models.StyleGANXL is StyleGANXL
