"""The port's guided denoise step against a JAX twin of bench.py:139-154 at
TINY size (TINY UNet and VAE, the tiny CLIP of __graft_entry__.py), fp32 on
the CPU, same weights and inputs; and the port's import hygiene."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceptor_tpu.losses.prompt_bank import spherical_distance_squared
from perceptor_tpu.models.clip.model import CLIP as JCLIP
from perceptor_tpu.models.open_clip import CLIP_MEAN, CLIP_STD
from perceptor_tpu.models.stable_diffusion import AutoencoderKL as JVAE
from perceptor_tpu.models.stable_diffusion import UNet as JUNet
from perceptor_tpu.models.stable_diffusion import config as jsd_config
from perceptor_tpu.ops.resize import resize
from perceptor_tpu.predictions import LatentIndexedEpsPredictions
from perceptor_tpu.schedules import scaled_linear_alphas_sigmas
from perceptor_tpu_torch import convert, guided_step

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
# max |grad error| over max |grad|: fp32 through UNet, VAE and CLIP
GRAD_RTOL = 1e-4
# `guided` divides the clipped gradient by clamp_value = 1e-6, so a 1e-12
# gradient difference moves the shift by 1e-6 x sigma: the stepped latents
# are compared with both sides given the JAX gradient, where only the UNet's
# noise (atol 1e-4 in tests/test_torch_models.py) separates them
STEPPED_ATOL = 1e-4


def _random_params(init_fn, *args, seed):
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

    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0), *args)["params"]
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _jax_guided_step(unet_params, vae_params, clip_params, latents, context, target):
    """bench.py's guided_denoise_step at the TINY configs."""
    unet = JUNet(jsd_config.TINY_UNET)
    vae = JVAE(jsd_config.TINY_VAE)
    clip = JCLIP(guided_step.TINY_CLIP)
    alphas, sigmas = scaled_linear_alphas_sigmas()
    mean = np.asarray(CLIP_MEAN).reshape(1, 3, 1, 1)
    std = np.asarray(CLIP_STD).reshape(1, 3, 1, 1)
    from_idx, to_idx = np.array([800]), np.array([780])

    def make_predictions(latents, noise):
        return LatentIndexedEpsPredictions(
            from_diffused_latents=latents, from_indices=from_idx, predicted_noise=noise,
            schedule_alphas=alphas, schedule_sigmas=sigmas,
        )

    def loss_fn(latents):
        noise = unet.apply({"params": unet_params}, latents, from_idx * 1.0, context)
        images = vae.apply({"params": vae_params}, make_predictions(latents, noise).denoised_xs,
                           method="decode")
        images = (resize(images, out_shape=guided_step.TINY_CLIP.image_size) - mean) / std
        enc = clip.apply({"params": clip_params}, images, method=JCLIP.encode_image)
        enc = enc / jnp.maximum(jnp.linalg.norm(enc, axis=-1, keepdims=True), 1e-12)
        return spherical_distance_squared(enc, target).mean(), noise

    (loss, noise), grads = jax.value_and_grad(loss_fn, has_aux=True)(latents)
    stepped = make_predictions(latents, noise).guided(grads, guidance_scale=0.5).step(to_idx)
    return stepped, loss, grads, noise


@pytest.fixture(scope="module")
def tiny_step():
    clip_cfg = guided_step.TINY_CLIP
    unet_params = _random_params(
        JUNet(jsd_config.TINY_UNET).init, jnp.zeros((1, 4, 8, 8)), jnp.zeros((1,)),
        jnp.zeros((1, 8, 32)), seed=0,
    )
    vae_params = _random_params(JVAE(jsd_config.TINY_VAE).init, jnp.zeros((1, 3, 16, 16)), seed=1)
    clip_params = _random_params(
        JCLIP(clip_cfg).init, jnp.zeros((1, 3, 32, 32)),
        jnp.zeros((1, clip_cfg.context_length), jnp.int32), seed=2,
    )
    step = guided_step.build("tiny", device="cpu", seed=0)
    step.unet.load_state_dict(convert.unet_state_dict_from_jax(unet_params, jsd_config.TINY_UNET))
    step.vae.load_state_dict(convert.vae_state_dict_from_jax(vae_params, jsd_config.TINY_VAE))
    step.clip.load_state_dict(convert.clip_state_dict_from_jax(clip_params, clip_cfg))
    rng = np.random.default_rng(3)
    latents = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
    context = rng.standard_normal((1, 8, 32)).astype(np.float32)
    jax_out = jax.jit(_jax_guided_step)(
        unet_params, vae_params, clip_params, jnp.asarray(latents), jnp.asarray(context),
        jnp.asarray(step.target.numpy()),
    )
    return step, latents, context, [np.array(x) for x in jax_out]


def test_tiny_guided_step_matches_jax(tiny_step):
    step, latents, context, (j_stepped, j_loss, j_grad, _) = tiny_step
    t_latents, t_context = torch.from_numpy(latents), torch.from_numpy(context)

    x = t_latents.clone().requires_grad_(True)
    loss, noise = step.loss_and_noise(x, t_context)
    (grad,) = torch.autograd.grad(loss, x)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=LOSS_RTOL)
    grad_err = np.abs(grad.numpy() - j_grad).max() / np.abs(j_grad).max()
    assert grad_err <= GRAD_RTOL, grad_err

    stepped = step.step_with_gradient(t_latents, noise.detach(), torch.tensor(j_grad))
    np.testing.assert_allclose(stepped.numpy(), j_stepped, atol=STEPPED_ATOL)

    # the public entry point is the same composition
    entry_stepped, entry_loss = step.guided_denoise_step(t_latents, t_context)
    np.testing.assert_allclose(float(entry_loss), float(loss.detach()), rtol=1e-6)
    np.testing.assert_allclose(
        entry_stepped.numpy(),
        step.step_with_gradient(t_latents, noise.detach(), grad).numpy(), atol=1e-6,
    )


def test_tiny_guided_steps_stay_finite():
    step = guided_step.build("tiny", device="cpu", seed=0)
    latents, context = step.initial_inputs()
    losses = []
    for _ in range(3):
        latents, loss = step.guided_denoise_step(latents, context)
        losses.append(float(loss))
    assert latents.shape == (1, 4, 8, 8) and torch.isfinite(latents).all()
    assert all(np.isfinite(losses))


def test_port_imports_no_jax():
    """Every module of the port, chip_smoke.py and bench_cuda.py import
    without jax, flax, optax or perceptor_tpu; the entry points by name too,
    the lazily exported ones resolved, the sessions, stats and serving
    modules among them, and the converter CLI runs its `--help`."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import perceptor_tpu_torch, chip_smoke, bench_cuda\n"
        "import perceptor_tpu_torch.models.stable_diffusion.stable_diffusion\n"
        "import perceptor_tpu_torch.models.clip.tokenizer\n"
        "import perceptor_tpu_torch.engine.guidance\n"
        "for name in ('utils.cache', 'utils.gradients', 'models.open_clip', 'models.clip_alias',\n"
        "             'losses.interface', 'losses.prompt_bank', 'losses.clip', 'losses.open_clip',\n"
        "             'losses.smoothness', 'losses.resize', 'losses.spherical_distance',\n"
        "             'transforms.interface', 'transforms.clamp', 'transforms.dynamic_threshold',\n"
        "             'transforms.resize_transform', 'transforms.cutouts', 'drawers.interface',\n"
        "             'drawers.inits', 'drawers.raw', 'drawers.jpeg.codec', 'drawers.jpeg.jpeg',\n"
        "             'drawers.brute_diffusion', 'losses.velocity_diffusion', 'schedules.cosine',\n"
        "             'predictions.velocity', 'models.guided_diffusion.unet',\n"
        "             'models.guided_diffusion.guided_diffusion', 'models.velocity_diffusion.net',\n"
        "             'models.velocity_diffusion.pndm',\n"
        "             'models.velocity_diffusion.velocity_diffusion', 'models.stable_diffusion.convert',\n"
        "             'models.latent_diffusion.bert', 'models.latent_diffusion.first_stage',\n"
        "             'models.latent_diffusion.ddim', 'models.latent_diffusion.text2image',\n"
        "             'models.latent_diffusion.face', 'models.latent_diffusion.super_resolution',\n"
        "             'ops.upfirdn', 'schedules.edm', 'predictions.edm', 'models.clip.resnet',\n"
        "             'models.monster_diffusion.net', 'models.monster_diffusion.monster_diffusion',\n"
        "             'models.vgg', 'models.lpips', 'models.resnet', 'models.resmem',\n"
        "             'models.transformers_openai_clip', 'models.simulacra_aesthetic',\n"
        "             'losses.lpips', 'losses.style_transfer', 'losses.memorability',\n"
        "             'losses.transformers_openai_clip', 'losses.simulacra_aesthetic',\n"
        "             'losses.aesthetic_visual_assessment', 'models.adabins_depth',\n"
        "             'models.midas_depth', 'losses.midas_depth', 'utils.flops',\n"
        "             'utils.profiling', 'utils.bench_env', 'core.remat', 'models.dual_encoder',\n"
        "             'models.slip', 'models.blip', 'models.cloob', 'models.lit', 'models.ruclip',\n"
        "             'losses.slip', 'losses.blip', 'losses.cloob', 'losses.lit', 'losses.ruclip',\n"
        "             'ops.deform_conv', 'models.deep_image_prior', 'drawers.deep_image_prior',\n"
        "             'ops.fma', 'ops.bias_act', 'ops.gradfix', 'ops.filtered_lrelu',\n"
        "             'ops.conv2d_resample', 'ops.grid_sample', 'models.stylegan_xl',\n"
        "             'drawers.stylegan_xl', 'utils.checkpoints', 'utils.native_io',\n"
        "             'utils.pil_image', 'utils.session', 'utils.stats', 'utils.serving',\n"
        "             'convert', 'core.shapes', 'core.pytree', 'core.dtypes', 'core.init',\n"
        "             'core.memo',\n"
        "             'parallel', 'parallel.mesh', 'parallel.plan', 'parallel.collectives',\n"
        "             'parallel.ring_attention', 'parallel.ulysses', 'parallel.partition',\n"
        "             'parallel.pipeline', 'parallel.strategies', 'utils.hlo', 'utils.hlo_trace',\n"
        "             'ops.groupnorm', 'ops.upsample_conv'):\n"
        "    importlib.import_module('perceptor_tpu_torch.' + name)\n"
        "from perceptor_tpu_torch import drawers, engine, losses, models, transforms, utils\n"
        "losses.CLIP, losses.OpenCLIP, models.CLIP, models.OpenCLIP, models.StableDiffusion\n"
        "drawers.Raw, drawers.JPEG, engine.optimize, engine.run_on_device, transforms.random_cutouts\n"
        "models.GuidedDiffusion, models.VelocityDiffusion, losses.VelocityDiffusion\n"
        "drawers.BruteDiffusion, models.MonsterDiffusion\n"
        "models.VGG19, models.ResMem, models.SimulacraAesthetic, models.TransformersOpenAICLIP\n"
        "losses.LPIPS, losses.StyleTransfer, losses.Memorability, losses.SimulacraAesthetic\n"
        "losses.AestheticVisualAssessment, losses.TransformersOpenAICLIP\n"
        "models.MidasDepth, models.AdaBinsDepth, losses.MidasDepth\n"
        "models.SLIP, models.BLIP, models.CLOOB, models.LiT, models.RuCLIP, models.DeepImagePrior\n"
        "losses.SLIP, losses.BLIP, losses.CLOOB, losses.LiT, losses.RuCLIP\n"
        "drawers.DeepImagePrior, perceptor_tpu_torch.ops.deform_conv2d\n"
        "perceptor_tpu_torch.parallel.strategies.register()\n"
        "models.StyleGANXL, drawers.StyleGANXL, utils.pil_image\n"
        "o = perceptor_tpu_torch.ops\n"
        "o.bias_act, o.filtered_lrelu, o.conv2d_resample, o.grid_sample, o.flow_warp, o.fma\n"
        "from perceptor_tpu_torch.utils.checkpoints import find_checkpoint, load_state_dict\n"
        "from perceptor_tpu_torch.utils import SessionManager, save_session, load_session\n"
        "from perceptor_tpu_torch.utils import serving, stats\n"
        "serving.serialize_program, stats.Collector, engine.export_guided_sample\n"
        "import contextlib, io\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    try:\n"
        "        perceptor_tpu_torch.convert.main(['--help'])\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0\n"
        "from perceptor_tpu_torch.utils.native_io import native_available, read_span\n"
        "from perceptor_tpu_torch.models.stable_diffusion import Conditioning\n"
        "ld = models.latent_diffusion\n"
        "ld.Text2Image, ld.Face, ld.SuperResolution, ld.VQModel, ld.VectorQuantizer\n"
        "ld.BERTEncoder, ld.BERTTokenizer, ld.convert_compvis_autoencoder\n"
        "for m in pkgutil.walk_packages(perceptor_tpu_torch.__path__, 'perceptor_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'flax', 'optax', 'perceptor_tpu'))\n"
        "assert not bad, bad\n"
        "print('HYGIENE_OK')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and "HYGIENE_OK" in proc.stdout, proc.stderr[-2000:]


def test_entry_point_without_cpu_raises_on_a_machine_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        guided_step.build("tiny")


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
