"""The port's OWL-ViT (`models/owlvit.py`, `losses/owlvit.py`) and its
converter against the JAX package at the JAX `TINY` config, on the CPU.

Both packages hold the same weights: the JAX param tree re-drawn from a
seeded numpy rng, carried across with `convert.owlvit_state_dict_from_jax`,
whose HF names the JAX package's `convert_owlvit` reads back. The JAX
wrappers are built unmemoized (`__wrapped__`); their fp32 runs swap in an
fp32 module before the first jitted call. Token ids stay under the tiny
vocabulary's 64 (a stand-in tokenizer: start 62, end of text 63). fp32
outputs and input gradients are held to RTOL of the reference's largest
magnitude; the bf16 build to BF16_RTOL relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceptor_tpu.losses.owlvit import OWLViT as JOWLViTLoss
from perceptor_tpu.models import owlvit as jowlvit
from perceptor_tpu.models.clip.tokenizer import tokenize as jtokenize
from perceptor_tpu_torch import convert, losses, models
from perceptor_tpu_torch.models import owlvit
from perceptor_tpu_torch.models.clip.tokenizer import tokenize
from test_torch_rudalle import close, fill_params, np_tree, rel_l2

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)

RTOL = 1e-4
BF16_RTOL = 3e-2
CFG = jowlvit.TINY
QUERIES = ["a cat", "two dogs on a long sofa"]


class _ByteTokenizer:
    """CLIP's tokenizer interface with ids under the tiny vocabulary's 64."""

    sot_token, eot_token = 62, 63

    def encode(self, text):
        return [ord(c) % 60 + 1 for c in text]


TOKENIZER = _ByteTokenizer()
_PARAMS = {}


def _params():
    if "p" not in _PARAMS:
        jmodule = jowlvit.OWLViTDetection(CFG)
        params = jmodule.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 64, 64)),
                              jnp.zeros((1, CFG.context_length), jnp.int32))["params"]
        _PARAMS["p"] = fill_params(params, 21)
    return _PARAMS["p"]


def _images(seed, shape):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def test_tokenize_keeps_the_end_of_text_on_truncation():
    got = tokenize(QUERIES, CFG.context_length, tokenizer=TOKENIZER)
    want = jtokenize(QUERIES, CFG.context_length, tokenizer=TOKENIZER)
    np.testing.assert_array_equal(got, want)
    assert (got.argmax(-1) == [len("a cat") + 1, CFG.context_length - 1]).all()


def test_detection_module_matches_jax():
    """Logits and boxes of the fp32 module, and the input gradient of a
    probe of both; JAX's `convert_owlvit` reads the port's names back."""
    params = _params()
    sd = convert.owlvit_state_dict_from_jax(np_tree(params), CFG)
    back = jowlvit.convert_owlvit({k: v.numpy() for k, v in sd.items()}, CFG)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, np_tree(params))
    port = owlvit.OWLViTDetection(CFG)
    port.load_state_dict(sd)
    port.requires_grad_(False)

    x = np.random.default_rng(22).standard_normal((2, 3, 64, 64)).astype(np.float32)
    tokens = tokenize(QUERIES + ["red"], CFG.context_length, tokenizer=TOKENIZER)
    jmodule = jowlvit.OWLViTDetection(CFG)
    rng = np.random.default_rng(23)
    p_logits = rng.standard_normal((2, 4, 3)).astype(np.float32)
    p_boxes = rng.standard_normal((2, 4, 4)).astype(np.float32)

    def jfn(im):
        logits, boxes = jmodule.apply({"params": params}, im, jnp.asarray(tokens))
        return jnp.sum(logits * p_logits) + jnp.sum(boxes * p_boxes), (logits, boxes)

    (_, (want_logits, want_boxes)), want_grad = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    logits, boxes = port(xt, torch.from_numpy(tokens))
    ((logits * torch.from_numpy(p_logits)).sum() + (boxes * torch.from_numpy(p_boxes)).sum()
     ).backward()
    close(logits.detach(), want_logits)
    close(boxes.detach(), want_boxes)
    close(xt.grad, want_grad)


def _wrappers(fp32):
    """Unmemoized "tiny" wrappers of both packages with the same weights."""
    jmodel = jowlvit.OWLViT.__wrapped__("tiny", tokenizer=TOKENIZER)
    if fp32:
        jmodel.module = jowlvit.OWLViTDetection(CFG)
    jmodel.params = _params()
    model = models.OWLViT.__wrapped__("tiny", tokenizer=TOKENIZER,
                                      precision="fp32" if fp32 else None, device="cpu")
    sd = convert.owlvit_state_dict_from_jax(np_tree(jmodel.params), CFG)
    # an HF file's CLIP head and position ids are dropped on load
    sd.update({"owlvit.visual_projection.weight": torch.zeros(4, 4),
               "owlvit.logit_scale": torch.zeros(()),
               "owlvit.text_model.embeddings.position_ids": torch.arange(8)[None]})
    model.load_state_dict(sd)
    return jmodel, model


@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
def test_wrapper_forward_matches_jax(fp32):
    """`forward` on 48px images (resized to 64): logits, xyxy pixel boxes,
    scores and labels."""
    jmodel, model = _wrappers(fp32)
    images = _images(24, (2, 3, 48, 48))
    encodings = model.encode_texts([QUERIES])
    assert encodings.texts == (tuple(QUERIES),)
    want = jmodel(jnp.asarray(images), jmodel.encode_texts([QUERIES]))
    got = model(torch.from_numpy(images), encodings)
    assert got.logits.shape == (2, 4, 2) and got.boxes.shape == (2, 4, 4)
    if fp32:
        for name in ("logits", "boxes", "scores"):
            close(getattr(got, name), getattr(want, name))
        np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    else:
        for name in ("logits", "boxes", "scores"):
            assert rel_l2(getattr(got, name), getattr(want, name)) <= BF16_RTOL


def test_loss_matches_jax():
    """The weighted top-k loss and its input gradient (fp32); one set of
    encodings only; no image prompts."""
    jmodel, model = _wrappers(fp32=True)
    jloss = JOWLViTLoss(name="tiny", tokenizer=TOKENIZER)
    jloss.model = jmodel
    jloss.add_texts_(QUERIES, weights=[1.0, 0.5])
    loss = losses.OWLViT(name="tiny", tokenizer=TOKENIZER, device="cpu")
    loss.model = model
    loss.add_texts_(QUERIES, weights=[1.0, 0.5])
    images = _images(25, (2, 3, 64, 64))
    want, want_grad = jax.jit(jax.value_and_grad(lambda im: jloss.forward(im, top_k=2)))(
        jnp.asarray(images))
    xt = torch.from_numpy(images).requires_grad_(True)
    value = loss(xt, top_k=2)
    value.backward()
    close(value.detach(), want)
    close(xt.grad, want_grad)
    with pytest.raises(ValueError, match="one set of encodings"):
        loss.add_texts_(["again"])
    with pytest.raises(NotImplementedError):
        loss.add_images_(xt)
