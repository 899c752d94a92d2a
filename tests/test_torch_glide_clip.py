"""The port's GLIDE noise-aware CLIP (`models/glide_clip.py`) and its
converter against the JAX package at the JAX `TINY` config, on the CPU.

Both packages hold the same weights: the JAX param trees re-drawn from a
seeded numpy rng, carried across with `convert.glide_clip_state_dict_from_jax`,
whose GLIDE names the JAX package's `convert_glide_text` /
`convert_glide_image` read back. The JAX wrapper is built unmemoized
(`__wrapped__`); its fp32 run swaps in fp32 towers before the first jitted
call. fp32 outputs and input gradients are held to RTOL of the reference's
largest magnitude; the bf16 build to BF16_RTOL relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceptor_tpu.models import glide_clip as jglide
from perceptor_tpu_torch import convert, models
from perceptor_tpu_torch.models import glide_clip
from test_torch_rudalle import close, fill_params, np_tree, rel_l2

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)

RTOL = 1e-4
BF16_RTOL = 3e-2
CFG = jglide.TINY
# ids past the tiny vocabulary's 64 (taken modulo n_vocab), one prompt past
# max_text_len (truncated) and an empty one (pooled at position 0)
PROMPTS = ["a cat on the moon", "the longest prompt in this little test", ""]
_PARAMS = {}


class _WideTokenizer:
    """`encode` only, as GLIDE uses it: ids from 1 to 200."""

    def encode(self, text):
        return [ord(c) * 7 % 200 + 1 for c in text]


TOKENIZER = _WideTokenizer()


def _params():
    if "p" not in _PARAMS:
        key = jax.random.PRNGKey(0)
        text = jglide.GlideTextEncoder(CFG).init(
            key, jnp.zeros((1, CFG.max_text_len), jnp.int32), jnp.ones((1,), jnp.int32))["params"]
        image = jglide.GlideImageEncoder(CFG).init(
            key, jnp.zeros((1, 3, CFG.image_size, CFG.image_size)),
            jnp.zeros((1,), jnp.int32))["params"]
        _PARAMS["p"] = fill_params({"text": text, "image": image}, 31)
    return _PARAMS["p"]


def _images(seed, shape):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def test_towers_match_jax():
    """Both fp32 towers, and the image tower's input gradient; JAX's
    converters read the port's names back."""
    params = _params()
    sds = convert.glide_clip_state_dict_from_jax(np_tree(params), CFG)
    for convert_back, key in ((jglide.convert_glide_text, "text"),
                              (jglide.convert_glide_image, "image")):
        back = convert_back({k: v.numpy() for k, v in sds[key].items()}, CFG)
        jax.tree_util.tree_map(np.testing.assert_array_equal, back, np_tree(params[key]))
    text = glide_clip.GlideTextEncoder(CFG)
    text.load_state_dict(sds["text"])
    image = glide_clip.GlideImageEncoder(CFG)
    image.load_state_dict(sds["image"])
    image.requires_grad_(False)

    tokens = np.random.default_rng(32).integers(0, CFG.n_vocab, (2, CFG.max_text_len))
    lens = np.array([5, CFG.max_text_len])
    want = jax.jit(lambda t, n: jglide.GlideTextEncoder(CFG).apply(
        {"params": params["text"]}, t, n))(jnp.asarray(tokens, jnp.int32), jnp.asarray(lens))
    with torch.no_grad():
        close(text(torch.from_numpy(tokens), torch.from_numpy(lens)), want)

    x = _images(33, (2, 3, 32, 32)) * 255
    ts = np.array([3, 7])
    probe = np.random.default_rng(34).standard_normal((2, CFG.n_embd)).astype(np.float32)

    def jfn(im):
        out = jglide.GlideImageEncoder(CFG).apply({"params": params["image"]}, im,
                                                  jnp.asarray(ts))
        return jnp.sum(out * probe), out

    (_, want), want_grad = jax.jit(jax.value_and_grad(jfn, has_aux=True))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = image(xt, torch.from_numpy(ts))
    (got * torch.from_numpy(probe)).sum().backward()
    close(got.detach(), want)
    close(xt.grad, want_grad)


def _wrappers(fp32):
    jmodel = jglide.GlideCLIP.__wrapped__("tiny", tokenizer=TOKENIZER)
    if fp32:
        jmodel.text_encoder = jglide.GlideTextEncoder(CFG)
        jmodel.image_encoder = jglide.GlideImageEncoder(CFG)
    jmodel.params = _params()
    model = models.GlideCLIP.__wrapped__("tiny", tokenizer=TOKENIZER,
                                         precision="fp32" if fp32 else None, device="cpu")
    model.load_state_dicts(**convert.glide_clip_state_dict_from_jax(np_tree(jmodel.params), CFG))
    return jmodel, model


@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
def test_wrapper_matches_jax(fp32):
    """`encode_images` of 40px diffused images (resized to 32) at two
    timesteps and its input gradient, and `encode_texts` (ids modulo
    n_vocab, truncated, an empty prompt); unit norm."""
    jmodel, model = _wrappers(fp32)
    diffused = _images(35, (2, 3, 40, 40))
    ts = np.array([3, 7])
    probe = np.random.default_rng(36).standard_normal((2, CFG.n_embd)).astype(np.float32)
    want_grad = jax.jit(jax.grad(
        lambda d: jnp.sum(jmodel.encode_images_fn(jmodel.params, d, jnp.asarray(ts)) * probe),
    ))(jnp.asarray(diffused))
    want = jmodel.encode_images(jnp.asarray(diffused), jnp.asarray(ts))
    xt = torch.from_numpy(diffused).requires_grad_(True)
    got = model.encode_images(xt, ts)
    (got * torch.from_numpy(probe)).sum().backward()
    texts, want_texts = model.encode_texts(PROMPTS), jmodel.encode_texts(PROMPTS)
    assert texts.shape == (3, CFG.n_embd)
    np.testing.assert_allclose(torch.linalg.norm(got, dim=-1).detach().numpy(), 1.0, atol=1e-5)
    if fp32:
        close(got.detach(), want)
        close(xt.grad, want_grad)
        close(texts, want_texts)
    else:
        assert rel_l2(got.detach(), want) <= BF16_RTOL
        assert rel_l2(texts, want_texts) <= BF16_RTOL
    # one timestep for the batch broadcasts as JAX's atleast_1d does
    torch.testing.assert_close(model.encode_images(xt[:1], 3), got[:1])
