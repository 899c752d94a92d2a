"""The port's serving (`utils/serving.py` over `torch.export`) on the CPU at
TINY size: the flash kernels as registered ops (`torch.library.opcheck`,
and three op nodes in an exported graph), Stable Diffusion's
`export_sample` (DDIM and dpm++) and `export_conditioning` against the JAX
package's own `export_sample` artifact on the same weights and inputs and
against the port's live sampler, v-diffusion's `export_sample`,
`engine.export_guided_sample` against the live `guided_sample` (plain and
CFG, and stochastic with pre-drawn noise), the refusals, `save_programs` /
`load_programs`, and that no weight is baked into an artifact.

A loaded port artifact runs the graph the live sampler traced, on the same
CPU kernels, so the two are held bitwise equal. Against JAX's artifact
(another implementation of the same fp32 program) the images are held to
2e-5 absolute at O(1) magnitudes.
"""

import io
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)
from perceptor_tpu.models.clip.tokenizer import SimpleTokenizer
from perceptor_tpu.models.stable_diffusion import StableDiffusion as JStableDiffusion
from perceptor_tpu.models.stable_diffusion import config as jsd_config
from perceptor_tpu.utils import serving as jserving
from perceptor_tpu_torch import convert, losses
from perceptor_tpu_torch.engine import export_guided_sample, guided_noise_shape, guided_sample
from perceptor_tpu_torch.models.clip.configs import CLIPConfig
from perceptor_tpu_torch.models.stable_diffusion import StableDiffusion
from perceptor_tpu_torch.models.velocity_diffusion import VelocityDiffusion
from perceptor_tpu_torch.ops import flash_attention_kernel as fa
from perceptor_tpu_torch.predictions.base import draw_noise
from perceptor_tpu_torch.utils import serving

JAX_ATOL = 2e-5
SIZE = (16, 16)
N_STEPS = 2


@pytest.fixture(scope="module")
def models():
    """(JAX SD, port SD) on the JAX tiny model's seed-0 weights."""
    jsd = JStableDiffusion.__wrapped__("tiny", fp16=False, tokenizer=SimpleTokenizer(merges=[]))
    sd = StableDiffusion("tiny", fp16=False, device="cpu")
    sd.load_state_dicts(convert.stable_diffusion_state_dicts_from_jax(
        jax.tree.map(np.asarray, jsd.params), jsd_config.TINY_UNET, jsd_config.TINY_VAE,
        jsd_config.TINY_TEXT))
    return jsd, sd


@pytest.fixture(scope="module")
def inputs(models):
    _, sd = models
    rng = np.random.default_rng(11)
    shape = sd.sample_noise_shape(1, SIZE, N_STEPS)
    return {
        "context2": rng.standard_normal(
            (2, sd.text_config.context_length, sd.unet_config.context_dim)).astype(np.float32),
        "latents": rng.standard_normal(shape[1:]).astype(np.float32),
    }


def _weight_bytes(params):
    return sum(t.numel() * t.element_size() for tensors in params.values()
               for t in tensors.values())


def _constant_bytes(blob):
    """Bytes the archive holds besides the graph: its tensor constants."""
    with zipfile.ZipFile(io.BytesIO(blob)) as archive:
        return sum(i.file_size for i in archive.infolist()
                   if "/data/" in i.filename and not i.filename.endswith(".json"))


# -- the registered ops ---------------------------------------------------------


def test_flash_ops_pass_opcheck():
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, 2, 128, 16)).astype(np.float32))
                   for _ in range(4))
    lse = torch.from_numpy(rng.standard_normal((1, 2, 128)).astype(np.float32))
    delta = torch.from_numpy(rng.standard_normal((1, 2, 128)).astype(np.float32))
    torch.library.opcheck(torch.ops.perceptor_tpu_torch.flash_fwd,
                          (q.requires_grad_(), k.requires_grad_(), v.requires_grad_(), 0.25))
    for op in (torch.ops.perceptor_tpu_torch.flash_dq, torch.ops.perceptor_tpu_torch.flash_dkv):
        torch.library.opcheck(op, (q.detach(), k.detach(), v.detach(), do, lse, delta, 0.25))


def test_forced_flash_route_exports_with_the_three_op_nodes():
    from perceptor_tpu_torch.ops.attention import attention

    def fn(q, k, v):
        q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
        with torch.enable_grad():
            o = attention(q, k, v, use_flash=True)
            return (o, *torch.autograd.grad(o.square().sum(), (q, k, v)))

    rng = np.random.default_rng(1)
    args = tuple(torch.from_numpy(rng.standard_normal((1, 2, 128, 12)).astype(np.float32))
                 for _ in range(3))  # head_dim 12: padded to 16 and sliced back
    program = serving.export_program(fn, *args, grad=True)
    ops = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        assert f"perceptor_tpu_torch.{name}.default" in ops, sorted(ops)
    loaded = serving.load_program(serving.serialize_program(fn, *args, grad=True))
    for got, want in zip(loaded(*args), fn(*args)):
        assert torch.equal(got, want)
    assert fa.LAUNCHES == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}  # the CPU launches none


# -- Stable Diffusion ----------------------------------------------------------------


@pytest.mark.parametrize("method", ["ddim", "dpm++"])
def test_sd_export_sample_matches_jax_artifact_and_live(models, inputs, method):
    jsd, sd = models
    blob = sd.export_sample(batch=1, size=SIZE, n_steps=N_STEPS, method=method)
    program = serving.load_program(blob)
    context2, latents = torch.from_numpy(inputs["context2"]), torch.from_numpy(inputs["latents"])
    noise = torch.zeros(sd.sample_noise_shape(1, SIZE, N_STEPS))
    assert noise.shape[0] == 0
    served = program(sd.params, context2, latents, noise, torch.tensor(4.5))

    pairs = sd.schedule_indices(N_STEPS)
    live = sd.decode(sd.sample_loop(latents, pairs, context2[:1], context2[1:], 4.5,
                                    method=method))
    assert torch.equal(served, live)

    jblob = jsd.export_sample(batch=1, size=SIZE, n_steps=N_STEPS, method=method)
    jserved = jserving.load_program(jblob)(
        jsd.params, jnp.asarray(inputs["context2"]), jnp.asarray(inputs["latents"]),
        jax.random.PRNGKey(0), jnp.float32(4.5))
    np.testing.assert_allclose(served.numpy(), np.asarray(jserved), atol=JAX_ATOL)
    # the weights are an argument, not constants of the artifact
    assert _constant_bytes(blob) < 0.1 * _weight_bytes(sd.params)


def test_sd_export_sample_stochastic_takes_the_live_noise(models, inputs):
    _, sd = models
    options = dict(eta=0.5, n_resample=1)
    blob = sd.export_sample(batch=1, size=SIZE, n_steps=1, **options)
    shape = sd.sample_noise_shape(1, SIZE, 1, **options)
    assert shape[0] == 2
    noise = draw_noise(torch.Generator().manual_seed(3), shape)
    context2, latents = torch.from_numpy(inputs["context2"]), torch.from_numpy(inputs["latents"])
    served = serving.load_program(blob)(sd.params, context2, latents, noise, torch.tensor(7.0))
    live = sd.decode(sd.sample_loop(latents, sd.schedule_indices(1), context2[:1],
                                    context2[1:], 7.0, generator=torch.Generator().manual_seed(3),
                                    **options))
    assert torch.equal(served, live)


def test_sd_export_conditioning_matches_jax_and_live(models):
    jsd, sd = models
    blob = sd.export_conditioning(batch=1)
    tokens = np.random.default_rng(2).integers(0, 100, (2, sd.text_config.context_length))
    served = serving.load_program(blob)(sd.params, torch.from_numpy(tokens))
    assert torch.equal(served, sd.text_encoder(torch.from_numpy(tokens)))
    jserved = jserving.load_program(jsd.export_conditioning(batch=1))(
        jsd.params, jnp.asarray(tokens, jnp.int32))
    np.testing.assert_allclose(served.numpy(), np.asarray(jserved), atol=JAX_ATOL)
    specs = serving.input_specs(blob)
    assert specs[-1] == ((2, sd.text_config.context_length), torch.int64)


def test_conditioning_artifact_is_a_small_share_of_wider_weights():
    """At a width where the weights outweigh the graph, the whole archive is
    under a tenth of them: nothing of the weights is in it."""
    import dataclasses

    sd = StableDiffusion("tiny", fp16=False, device="cpu")
    sd.text_config = dataclasses.replace(sd.text_config, width=256, heads=4)
    from perceptor_tpu_torch.core.init import random_module
    from perceptor_tpu_torch.models.stable_diffusion.text_encoder import CLIPTextEncoder

    sd.text_encoder = random_module(CLIPTextEncoder, sd.text_config, sd.device,
                                    torch.Generator().manual_seed(0), torch.float32)
    blob = sd.export_conditioning(batch=1)
    assert len(blob) < 0.1 * _weight_bytes(sd.params)


def test_cross_platform_export_raises_on_a_host_without_cuda(models):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    _, sd = models
    with pytest.raises(NotImplementedError):
        sd.export_conditioning(batch=1, platforms=("cuda",))


# -- v-diffusion ---------------------------------------------------------------------


@pytest.mark.parametrize("eta, churn", [(0.0, 0.0), (0.5, 0.3)])
def test_velocity_export_sample_matches_live(eta, churn):
    model = VelocityDiffusion("tiny", fp16=False, device="cpu")
    blob = model.export_sample(n_images=1, n_steps=N_STEPS, eta=eta, churn=churn)
    diffused = model.random_diffused((1, *model.shape), torch.Generator().manual_seed(0))
    pairs = torch.as_tensor(model.schedule_ts(N_STEPS))
    noise = draw_noise(torch.Generator().manual_seed(4),
                       model.sample_noise_shape(1, model.shape, N_STEPS, eta, churn))
    served = serving.load_program(blob)(model.params, diffused, pairs, None, noise,
                                        torch.tensor(eta), torch.tensor(churn))
    live = model.sample_loop(diffused, model.schedule_ts(N_STEPS), eta=eta, churn=churn,
                             generator=torch.Generator().manual_seed(4))
    assert torch.equal(served, live)


# -- guided sampling -----------------------------------------------------------------

CLIP = CLIPConfig(
    embed_dim=16, image_size=(32, 32), patch_size=8, vision_width=24, vision_layers=1,
    vision_heads=2, context_length=12, vocab_size=64, text_width=20, text_layers=1,
    text_heads=2)


@pytest.fixture(scope="module")
def clip_loss():
    loss = losses.CLIP("ViT-B-32", config=CLIP, precision="fp32", device="cpu", seed=15)
    loss.add_encodings_(torch.from_numpy(
        np.random.default_rng(5).standard_normal((2, 16)).astype(np.float32)))
    return loss


@pytest.mark.parametrize("options", [{}, {"cfg": True}, {"eta": 0.5}],
                         ids=["plain", "cfg", "stochastic"])
def test_export_guided_sample_matches_live(models, inputs, clip_loss, options):
    _, sd = models
    cfg, eta = options.get("cfg", False), options.get("eta", 0.0)
    rng = np.random.default_rng(9)
    cond = torch.from_numpy(inputs["context2"][1:])
    uncond = torch.from_numpy(inputs["context2"][:1]) if cfg else None
    latents = torch.from_numpy(rng.standard_normal(inputs["latents"].shape).astype(np.float32))
    pairs = sd.schedule_indices(1, from_index=700)
    blob = export_guided_sample(sd, [clip_loss], latents, pairs, cond, eta=eta,
                                uncond_conditioning=uncond, loss_images="preview")
    noise = draw_noise(torch.Generator().manual_seed(6),
                       guided_noise_shape(latents, len(pairs), eta))
    args = [sd.params, latents, torch.as_tensor(pairs), [serving.object_params(clip_loss)],
            (cond, uncond) if cfg else cond, noise, torch.tensor(0.5), torch.tensor(eta)]
    if cfg:
        args.append(torch.tensor(3.0))
    served_latents, served_history = serving.load_program(blob)(*args)
    live_latents, live_history = guided_sample(
        sd, [clip_loss], latents, pairs, cond, guidance_scale=0.5, eta=eta,
        generator=torch.Generator().manual_seed(6), uncond_conditioning=uncond, cfg_scale=3.0,
        loss_images="preview")
    assert torch.equal(served_latents, live_latents)
    assert torch.equal(served_history, live_history)


def test_export_guided_sample_refusals(models, inputs, clip_loss):
    _, sd = models
    latents = torch.from_numpy(inputs["latents"])
    pairs = sd.schedule_indices(1)
    cond = torch.from_numpy(inputs["context2"][1:])
    with pytest.raises(ValueError, match="plain callables"):
        export_guided_sample(sd, [lambda images: images.mean()], latents, pairs, cond)
    with pytest.raises(NotImplementedError, match="image_augment"):
        export_guided_sample(sd, [clip_loss], latents, pairs, cond,
                             image_augment=lambda generator, images: images)


def test_save_and_load_programs_roundtrip(tmp_path):
    blobs = {"a": serving.serialize_program(lambda x: x * 2, torch.ones(3)),
             "b": serving.serialize_program(lambda x: x.sum(), torch.ones(2, 2))}
    serving.save_programs(str(tmp_path), blobs)
    assert serving.load_programs(str(tmp_path)) == blobs
    assert torch.equal(serving.load_program(blobs["a"])(torch.ones(3)), torch.full((3,), 2.0))
