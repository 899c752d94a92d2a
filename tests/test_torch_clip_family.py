"""The port's CLIP-family dual encoders (`models/slip.py`, `blip.py`,
`cloob.py`, `lit.py`, `ruclip.py`), their prompt-bank losses and their
converters against the JAX package at the JAX `tiny` configs, on the CPU.

Both packages hold the same weights: the JAX wrapper's param tree, every
leaf re-drawn from a seeded numpy rng, carried across with the
`*_state_dict_from_jax` converters. The JAX wrappers are built unmemoized
(`__wrapped__`) so that no other test module's instance is touched; their
fp32 runs swap each tower for a `clone(dtype=float32)` of itself before the
first (jitted) call. Images and token ids come from numpy with a seed;
tokenizers are stand-ins whose ids fit the tiny vocabularies.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceptor_tpu.engine import guided_sample as j_guided_sample
from perceptor_tpu.losses.prompt_bank import PromptBankLoss as JPromptBankLoss
from perceptor_tpu.models import blip as jblip
from perceptor_tpu.models import cloob as jcloob
from perceptor_tpu.models import lit as jlit
from perceptor_tpu.models import ruclip as jruclip
from perceptor_tpu.models import slip as jslip
from perceptor_tpu.models.clip.convert import from_openclip
from perceptor_tpu.models.guided_diffusion import GuidedDiffusion as JGuidedDiffusion
from perceptor_tpu.models.latent_diffusion.bert import BERTTokenizer as JBERTTokenizer
from perceptor_tpu_torch import convert, drawers, losses, models
from perceptor_tpu_torch.engine import guided_sample
from perceptor_tpu_torch.models.guided_diffusion import GuidedDiffusion
from perceptor_tpu_torch.models.guided_diffusion import config as adm_config
from perceptor_tpu_torch.models.latent_diffusion.bert import BERTTokenizer

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)

# fp32 on both sides: max error over max magnitude
RTOL = 1e-4
# the port's bf16 build against JAX's fp32 run, relative L2: within this
# factor of JAX's own bf16 error on the same input (no two packages round
# bf16 alike)
BF16_FACTOR = 2.5
# the ensemble-guided sample, relative L2 of the final images and losses
LOOP_RTOL = 1e-4

IMAGE_SIZE = 40  # not the towers' 32: the wrappers' resize runs too
PROMPTS = ["a photo of a cat", "the cats"]
BERT_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "photo", "of", "the", "cat", "##s"]


class _ByteTokenizer:
    """CLIP's tokenizer interface with ids under the tiny vocabulary's 64:
    start 62, end of text 63 (CLOOB's vocab_size - 1)."""

    sot_token, eot_token = 62, 63

    def encode(self, text):
        return [ord(c) % 60 + 1 for c in text]


def _ruclip_tokenizer(texts):
    """youtokentome's layout, bos 2, eos 3, pad 0, in the tiny range."""
    rows = np.zeros((len(texts), 16), dtype=np.int64)
    for i, text in enumerate(texts):
        ids = [2] + [ord(c) % 50 + 10 for c in text][:13] + [3]
        rows[i, :len(ids)] = ids
    return rows


def fill_params(params, seed):
    """Every leaf re-drawn: weights N(0, 1 / fan_in), biases N(0, 0.1),
    LayerNorm scales near 1."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = np.shape(leaf)
        if name == "scale":
            out = 1.0 + 0.1 * rng.standard_normal(shape)
        elif len(shape) >= 2:
            out = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        else:
            out = 0.1 * rng.standard_normal(shape)
        return jnp.asarray(out.astype(np.float32))

    return jax.tree_util.tree_map_with_path(fill, params)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


# name -> (JAX module, port wrapper, JAX tower attributes, converter, config,
# tokenizers for JAX and the port)
SPECS = {
    "slip": (jslip, models.SLIP, ("visual", "text"), convert.slip_state_dict_from_jax,
             jslip.MODEL_CONFIGS["tiny"], _ByteTokenizer(), _ByteTokenizer()),
    "blip": (jblip, models.BLIP, ("visual", "text"), convert.blip_state_dict_from_jax,
             jblip.MODEL_CONFIGS["tiny"], JBERTTokenizer(BERT_VOCAB, 16),
             BERTTokenizer(BERT_VOCAB, 16)),
    "cloob": (jcloob, models.CLOOB, ("image_encoder", "text_encoder"),
              convert.cloob_state_dict_from_jax, jcloob.TINY, _ByteTokenizer(), _ByteTokenizer()),
    "lit": (jlit, models.LiT, ("visual", "text"), convert.lit_state_dict_from_jax,
            jlit.MODEL_CONFIGS["tiny"], JBERTTokenizer(BERT_VOCAB, 16),
            BERTTokenizer(BERT_VOCAB, 16)),
    "ruclip": (jruclip, models.RuCLIP, ("visual", "text"), None, None, _ruclip_tokenizer,
               _ruclip_tokenizer),
}
NAMES = list(SPECS)
_JAX_CLASS = {"slip": "SLIP", "blip": "BLIP", "cloob": "CLOOB", "lit": "LiT", "ruclip": "RuCLIP"}
_PARAMS = {}


def _params(name):
    """The re-drawn JAX param tree of `name`'s tiny wrapper (drawn once)."""
    if name not in _PARAMS:
        jmodule = SPECS[name][0]
        model = getattr(jmodule, _JAX_CLASS[name]).__wrapped__("tiny", tokenizer=SPECS[name][5])
        _PARAMS[name] = fill_params(model.params, seed=NAMES.index(name) + 1)
    return _PARAMS[name]


@functools.lru_cache(maxsize=None)
def jax_model(name, precision):
    """The unmemoized JAX wrapper over `_params(name)`, its towers in fp32
    or as built (bf16); one per (name, precision), so each traces once."""
    jmodule, _, towers, *_, jtok, _ = SPECS[name]
    model = getattr(jmodule, _JAX_CLASS[name]).__wrapped__("tiny", tokenizer=jtok)
    if precision == "fp32":
        for tower in towers:
            setattr(model, tower, getattr(model, tower).clone(dtype=jnp.float32))
    model.params = _params(name)
    return model


def port_state_dict(name):
    _, cls, *_ = SPECS[name]
    params = _np_tree(_params(name))
    if name == "ruclip":
        return convert.ruclip_state_dict_from_jax(params, jruclip.RuCLIP.__wrapped__(
            "tiny", tokenizer=_ruclip_tokenizer).config)
    return SPECS[name][3](params, SPECS[name][4])


def port_model(name, precision, **kwargs):
    _, cls, *_, ttok = SPECS[name]
    model = cls("tiny", tokenizer=ttok, precision=precision, device="cpu", **kwargs)
    model.load_state_dict(port_state_dict(name))
    return model


def _images(seed, n=2, size=IMAGE_SIZE):
    return np.random.default_rng(seed).uniform(size=(n, 3, size, size)).astype(np.float32)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, dtype=np.float32), np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= rtol * scale, (err, scale)


def _rel_l2(got, want):
    got, want = np.asarray(got, dtype=np.float32), np.asarray(want, dtype=np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("name", NAMES)
def test_towers_fp32_match_jax(name):
    """encode_images (resize, normalization, tower, projection, L2) and
    encode_texts (tokenizer, tower, pooling, L2) in fp32."""
    jm, port = jax_model(name, "fp32"), port_model(name, "fp32")
    x = _images(3)
    with torch.no_grad():
        _close(port.encode_images(torch.from_numpy(x)).numpy(), jm.encode_images(jnp.asarray(x)))
    _close(port.encode_texts(PROMPTS).numpy(), jm.encode_texts(PROMPTS))


@pytest.mark.parametrize("name", NAMES)
def test_towers_bf16_within_jax_bf16_error(name):
    """The port's bf16 build against JAX's fp32 run, relative L2, within
    BF16_FACTOR of JAX's own bf16 build's error."""
    jm32, jm16, port = jax_model(name, "fp32"), jax_model(name, "bf16"), port_model(name, None)
    x = _images(4)
    want = jm32.encode_images(jnp.asarray(x))
    with torch.no_grad():
        got = port.encode_images(torch.from_numpy(x))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert _rel_l2(got.numpy(), want) <= BF16_FACTOR * _rel_l2(jm16.encode_images(jnp.asarray(x)),
                                                               want)
    want = jm32.encode_texts(PROMPTS)
    assert _rel_l2(port.encode_texts(PROMPTS).numpy(), want) <= BF16_FACTOR * _rel_l2(
        jm16.encode_texts(PROMPTS), want)


_LOSSES = {"slip": losses.SLIP, "blip": losses.BLIP, "cloob": losses.CLOOB, "lit": losses.LiT,
           "ruclip": losses.RuCLIP}


def loss_pair(name, seed):
    """(JAX loss, port loss) over the same fp32 weights and two random
    targets weighted 1 and 0.5."""
    dim = port_model(name, "fp32").config.embed_dim
    targets = np.random.default_rng(seed).standard_normal((2, dim)).astype(np.float32)
    jloss = JPromptBankLoss(jax_model(name, "fp32")).add_encodings_(jnp.asarray(targets),
                                                                    [1.0, 0.5])
    loss = _LOSSES[name]("tiny", tokenizer=SPECS[name][6], precision="fp32", device="cpu")
    loss.model.load_state_dict(port_state_dict(name))
    return jloss, loss.add_encodings_(targets, [1.0, 0.5])


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_input_gradient_match_jax(name):
    jloss, loss = loss_pair(name, seed=5)
    x = _images(6, n=1)
    want, want_grad = jax.value_and_grad(lambda images: jloss(images))(jnp.asarray(x))
    images = torch.from_numpy(x).requires_grad_(True)
    value = loss(images)
    (grad,) = torch.autograd.grad(value, images)
    _close(value.detach().numpy(), want)
    _close(grad.numpy(), want_grad)
    assert float(np.abs(want_grad).max()) > 0


def _jax_tree_equal(got, want, skip=()):
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert set(flat_got) == set(flat_want) - set(skip), set(flat_got) ^ set(flat_want)
    for path, value in flat_got.items():
        np.testing.assert_array_equal(np.asarray(value), np.asarray(flat_want[path]),
                                      err_msg=str(path))


@pytest.mark.parametrize("name", NAMES)
def test_state_dict_round_trips_through_the_jax_converter(name):
    """The port module's fp32 state_dict through the JAX package's own
    converter gives back the param tree it was loaded from. LiT's
    converter folds BERT token-type embeddings into the word embeddings
    when a checkpoint has them; the port's module has none, so nothing is
    folded. RuCLIP's converter is CLIP's `from_openclip`, which also reads
    `logit_scale`: the JAX RuCLIP keeps none, so it is dropped."""
    state_dict = port_model(name, "fp32").module.state_dict()
    params = _np_tree(_params(name))
    if name == "ruclip":
        config = jruclip.RuCLIP.__wrapped__("tiny", tokenizer=_ruclip_tokenizer).config
        back = from_openclip(state_dict, config)
        back.pop("logit_scale")
    else:
        jconvert = {"slip": jslip.convert_slip, "blip": jblip.convert_blip,
                    "cloob": jcloob.convert_cloob, "lit": jlit.convert_lit}[name]
        back = jconvert(state_dict, SPECS[name][4])
    _jax_tree_equal(back, params)


def test_cloob_padded_query_rows_stay_finite_and_match_jax():
    """Rows padded after the end-of-text token: the reference masks their
    QUERIES (uniform attention over every key), so the tower stays finite;
    a -inf key mask would turn such rows into NaN."""
    jm, port = jax_model("cloob", "fp32"), port_model("cloob", "fp32")
    tokens = np.zeros((3, 16), dtype=np.int64)
    tokens[0, :4] = [62, 5, 9, 63]         # 12 padded positions
    tokens[1, :16] = [62] + [7] * 14 + [63]  # no padding
    tokens[2, :2] = [62, 63]               # 14 padded positions
    want = jm._jit_text(jm.params, jnp.asarray(tokens))
    got = port.encode_tokens(tokens)
    assert torch.isfinite(got).all()
    _close(got.numpy(), want)
    bf16 = port_model("cloob", None)
    assert torch.isfinite(bf16.encode_tokens(tokens)).all()


def test_blip_contrastive_distance_and_ruclip_tokenizer():
    rng = np.random.default_rng(8)
    a, b = rng.standard_normal((3, 16)), rng.standard_normal((2, 16))
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    got = models.BLIP.__wrapped__.image_text_contrastive_spherical_distance(
        torch.from_numpy(a).float(), torch.from_numpy(b).float())
    want = jblip.BLIP.__wrapped__.image_text_contrastive_spherical_distance(
        jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32))
    assert got.shape == (2, 3)
    _close(got.numpy(), want)
    ruclip = models.RuCLIP("tiny", device="cpu")
    with pytest.raises(ValueError, match="youtokentome"):
        ruclip.encode_texts(["привет"])
    # the first EOS, not the largest id, picks the pooled token
    tokens = torch.tensor([[2, 40, 3, 55, 3, 0], [2, 3, 0, 0, 0, 0]])
    assert ruclip.module.eot_positions(tokens).tolist() == [2, 1]


def test_moved_names_resolve_and_the_rest_still_raise():
    for name in ("SLIP", "BLIP", "CLOOB", "LiT", "RuCLIP", "DeepImagePrior"):
        assert callable(getattr(models, name))
    for name in ("SLIP", "BLIP", "CLOOB", "LiT", "RuCLIP"):
        assert issubclass(getattr(losses, name), losses.PromptBankLoss)
    assert issubclass(drawers.DeepImagePrior, drawers.DrawingInterface)
    # the next slice's names resolve to the port's classes
    from perceptor_tpu_torch.drawers.rudalle import BruteRuDalle
    from perceptor_tpu_torch.losses.owlvit import OWLViT as OWLViTLoss
    from perceptor_tpu_torch.models.glide_clip import GlideCLIP
    from perceptor_tpu_torch.models.owlvit import OWLViT
    from perceptor_tpu_torch.models.super_resolution import SuperResolution

    assert (models.GlideCLIP, models.OWLViT, models.SuperResolution) == (
        GlideCLIP, OWLViT, SuperResolution)
    assert losses.OWLViT is OWLViTLoss and drawers.BruteRuDalle is BruteRuDalle
    from perceptor_tpu_torch.drawers import stylegan_xl as drawer_module
    from perceptor_tpu_torch.models import stylegan_xl as model_module

    assert models.StyleGANXL is model_module.StyleGANXL
    assert drawers.StyleGANXL is drawer_module.StyleGANXL


def test_ensemble_guided_sample_matches_jax():
    """`engine.guided_sample` over tiny ADM under the tiny BLIP + CLOOB +
    SLIP ensemble (config 5 at tiny size), 2 steps: final images and the
    loss history against the JAX engine, relative L2 within LOOP_RTOL."""
    jgd = JGuidedDiffusion.__wrapped__("tiny", fp16=False)
    jgd.params = fill_params(jgd.params, seed=11)
    gd = GuidedDiffusion("tiny", fp16=False, device="cpu")
    gd.load_state_dict(convert.adm_state_dict_from_jax(_np_tree(jgd.params), adm_config.TINY))
    pairs = gd.schedule_indices(2, rho=3.0)
    np.testing.assert_array_equal(pairs, jgd.schedule_indices(n_steps=2, rho=3.0))
    start = np.random.default_rng(12).standard_normal((1, 3, 32, 32)).astype(np.float32)
    jlosses, tlosses = zip(*(loss_pair(name, seed) for seed, name in
                             enumerate(("blip", "cloob", "slip"), start=1)))
    kwargs = dict(guidance_scale=50.0, loss_weights=[1.0, 1.0, 1.0], clamp_value=1.0)
    j_images, j_history = j_guided_sample(jgd, list(jlosses), jnp.asarray(start), pairs, **kwargs)
    images, history = guided_sample(gd, list(tlosses), torch.from_numpy(start), pairs, **kwargs)
    assert _rel_l2(images.numpy(), j_images) <= LOOP_RTOL
    assert _rel_l2(history.numpy(), j_history) <= LOOP_RTOL
    unguided, _ = guided_sample(gd, list(tlosses), torch.from_numpy(start), pairs,
                                **{**kwargs, "guidance_scale": 0.0})
    assert _rel_l2(unguided.numpy(), images.numpy()) >= 1e-3
