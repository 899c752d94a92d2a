"""The port's CLIP ModifiedResNet image tower (`models/clip/resnet.py`, the
RN branch of `models/clip/model.py` and of `convert.py`) against the JAX
package at a narrow width, fp32 on the CPU, on the same weights (flax
params re-drawn from a seeded numpy rng, BatchNorm statistics included,
carried across with `convert.clip_state_dict_from_jax`) and the same
inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceptor_tpu import losses as jlosses
from perceptor_tpu.models.clip import convert as jclip_convert
from perceptor_tpu.models.clip.configs import CLIPConfig as JCLIPConfig
from perceptor_tpu.models.clip.configs import get_config as j_get_config
from perceptor_tpu.models.clip.model import CLIP as JCLIP
from perceptor_tpu.models.clip.resnet import ModifiedResNet as JModifiedResNet
from perceptor_tpu_torch import convert, losses, models
from perceptor_tpu_torch.models.clip.configs import CLIPConfig, get_config
from perceptor_tpu_torch.models.clip.model import CLIP
from perceptor_tpu_torch.models.clip.resnet import ModifiedResNet
from perceptor_tpu_torch.ops import flash_attention_kernel as tfa

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)

# fp32 on both sides through the ResNet: max error over max magnitude
RTOL = 1e-4

# a narrow RN: stages (1, 1, 2, 1) of width 8, 4 pooling heads of 64, 64px,
# the real vocabulary and context over a 2-layer text tower of width 20
TINY_RN = dict(
    embed_dim=16, image_size=(64, 64), patch_size=0, vision_width=8, vision_layers=(1, 1, 2, 1),
    vision_heads=8 * 32 // 64, context_length=77, vocab_size=49408, text_width=20,
    text_layers=2, text_heads=2, quick_gelu=True,
)


def _random_params(cfg: JCLIPConfig, seed):
    """Every leaf re-drawn; BatchNorm means N(0, 0.5) and variances in
    [0.5, 1.5], so the frozen statistics matter."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "scale":
            out = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        elif name == "mean":
            out = 0.5 * rng.standard_normal(leaf.shape)
        elif name == "var":
            out = rng.uniform(0.5, 1.5, leaf.shape)
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


@pytest.fixture(scope="module")
def pair():
    jcfg = JCLIPConfig(**TINY_RN)
    params = _random_params(jcfg, seed=0)
    module = CLIP(CLIPConfig(**TINY_RN))
    module.load_state_dict(convert.clip_state_dict_from_jax(params, jcfg))
    return jcfg, params, module.eval()


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    assert float(np.abs(np.asarray(got) - want).max()) <= rtol * float(np.abs(want).max())


def test_image_embedding_matches_jax(pair):
    jcfg, params, module = pair
    images = np.random.default_rng(1).standard_normal((2, 3, 64, 64)).astype(np.float32)
    want = jax.jit(lambda p, x: JCLIP(jcfg).apply({"params": p}, x, method=JCLIP.encode_image))(
        params, jnp.asarray(images))
    tfa.reset_launches()
    with torch.no_grad():
        got = module.encode_image(torch.from_numpy(images))
    assert isinstance(module.visual, ModifiedResNet)
    assert got.shape == (2, 16) and got.dtype == torch.float32
    assert not any(tfa.LAUNCHES.values())  # the pool's one query takes the plain route
    _close(got.numpy(), want)


def test_state_dict_round_trips_through_from_openclip(pair):
    """open_clip's RN names (`visual.layer1.0.downsample.0`, `bn*.running_*`,
    `attnpool.*_proj`): JAX's converter reads the port's state_dict back to
    the tree it came from; a checkpoint's `num_batches_tracked` loads."""
    jcfg, params, module = pair
    sd = {k: v.numpy() for k, v in module.state_dict().items()}
    assert {"visual.layer1.0.downsample.0.weight", "visual.layer2.0.downsample.1.running_var",
            "visual.attnpool.positional_embedding", "visual.attnpool.c_proj.bias",
            "visual.bn3.running_mean"} <= set(sd)
    back = jclip_convert.from_openclip(sd, jcfg)
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(got) == set(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf), err_msg=str(path))
    with_counts = dict(module.state_dict())
    with_counts["visual.bn1.num_batches_tracked"] = torch.tensor(7)
    CLIP(CLIPConfig(**TINY_RN)).load_state_dict(with_counts)


@pytest.mark.parametrize("size", [(64, 64), (80, 72)], ids=["native", "resized"])
def test_losses_clip_rn50_matches_jax(pair, size):
    """`losses.CLIP("RN50")` at the narrow config: text prompts through the
    real tokenizer, the loss and its image gradient against JAX's."""
    jcfg, params, _ = pair
    prompts = ["a photograph of a lighthouse", "an oil painting"]
    jloss = jlosses.CLIP("RN50", precision="fp32", config=jcfg)
    jloss.model.params = params
    jloss.add_texts_(prompts)
    loss = losses.CLIP("RN50", precision="fp32", config=CLIPConfig(**TINY_RN), device="cpu")
    loss.model.load_state_dict(convert.clip_state_dict_from_jax(params, jcfg))
    loss.add_texts_(prompts)
    assert loss.model.architecture == "RN50-quickgelu" and loss.model.weights == "openai"
    images = np.random.default_rng(2).uniform(size=(2, 3, *size)).astype(np.float32)
    x = torch.from_numpy(images).requires_grad_(True)
    value = loss(x)
    (grad,) = torch.autograd.grad(value, x)
    want, want_grad = jax.jit(jax.value_and_grad(lambda im: jloss(im)))(jnp.asarray(images))
    np.testing.assert_allclose(float(value.detach()), float(want), rtol=RTOL)
    _close(grad.numpy(), want_grad)


def test_published_rn_configs_build_with_jax_shapes():
    """RN50 and RN50x4 at their published widths and image sizes (224 /
    288): the port's image tower (built on the meta device) has JAX's
    parameter shapes, leaf for leaf."""
    for name in ("RN50", "RN50x4"):
        cfg, jcfg = get_config(name, "openai"), j_get_config(name, "openai")
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        with torch.device("meta"):
            module = CLIP(cfg)
        tower = JModifiedResNet(layers=tuple(jcfg.vision_layers), width=jcfg.vision_width,
                                heads=jcfg.vision_heads, output_dim=jcfg.embed_dim)
        shapes = jax.eval_shape(tower.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 3, *jcfg.image_size)))
        want = sorted(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes))
        got = sorted([p.numel() for p in module.visual.parameters()]
                     + [b.numel() for b in module.visual.buffers()])
        assert got == want, name
    assert get_config("RN50x16", "openai").image_size == (384, 384)
    assert get_config("RN50x64", "openai").image_size == (448, 448)


def test_rn_wrappers_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        models.OpenCLIP("RN50")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        losses.CLIP("RN50")
