"""Checkpoint discovery in the port's wrappers against the JAX package's, on
the CPU.

Names: for each of the JAX package's `find_checkpoint` call sites, the port
wrapper asks for exactly the JAX wrapper's candidate names, in its order.
`find_checkpoint` is replaced in the wrapper's module of each package by a
recorder that raises once the site has asked (so no full-width weights are
drawn after it), and the two recordings are compared.

Loads: a checkpoint in a temporary cache directory (or a path given) gives
the port the JAX wrapper's weights and outputs: JAX's `params-v1` artifact
(`save_params`) of a TINY Stable Diffusion and of a tiny OpenCLIP, an
open_clip-layout torch file through `OpenCLIP(checkpoint_path=)`, OpenAI
guided-diffusion names, torchvision VGG features, and the AVA and Simulacra
heads in their upstream layouts. fp32 throughout; outputs of the two
packages are held to 2e-5 at O(1) magnitudes, loaded weights bitwise.
With no file, the seeded random weights are what they were: the existing
parity tests hold them.
"""

import importlib
import types

import jax
import numpy as np
import pytest
import torch

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)
import perceptor_tpu.models as jmodels
import perceptor_tpu_torch.models as tmodels
from perceptor_tpu.utils import checkpoints as jcheckpoints
from perceptor_tpu_torch.utils import checkpoints as tcheckpoints

ATOL = 2e-5
IMAGES = np.zeros((1, 3, 32, 32), np.float32)


class _Asked(Exception):
    pass


def _recorder(calls, n_calls):
    def find_checkpoint(*names):
        calls.append(names)
        if len(calls) == n_calls:
            raise _Asked
        return None
    return find_checkpoint


def _fresh(cls):
    return getattr(cls, "__wrapped__", cls)


def _clip_stub(*args, **kwargs):
    return types.SimpleNamespace(config=types.SimpleNamespace(embed_dim=8),
                                 device=torch.device("cpu"))


# (module under perceptor_tpu[_torch], JAX construction, port construction,
# calls at the site); each construction takes the imported module.
SITES = {
    "rudalle": ("drawers.rudalle", lambda m: m.BruteRuDalle(IMAGES),
                lambda m: m.BruteRuDalle(IMAGES, device="cpu"), 1),
    "aesthetic_visual_assessment": (
        "losses.aesthetic_visual_assessment", lambda m: m.AestheticVisualAssessment(),
        lambda m: m.AestheticVisualAssessment(), 1),
    "super_resolution_discriminator": (
        "losses.super_resolution", lambda m: m.SuperResolutionDiscriminator(),
        lambda m: m.SuperResolutionDiscriminator(device="cpu"), 1),
    "monster_diffusion": ("models.monster_diffusion.monster_diffusion",
                          lambda m: _fresh(m.MonsterDiffusion)("tiny"),
                          lambda m: m.MonsterDiffusion("tiny", device="cpu"), 1),
    "adabins_depth": ("models.adabins_depth", lambda m: m.AdaBinsDepth("nyu"),
                      lambda m: m.AdaBinsDepth("nyu", device="cpu"), 1),
    "transformers_openai_clip": (
        "models.transformers_openai_clip",
        lambda m: _fresh(m.TransformersOpenAICLIP)("openai/clip-vit-base-patch32"),
        lambda m: _fresh(m.TransformersOpenAICLIP)("openai/clip-vit-base-patch32",
                                                   device="cpu"), 1),
    "open_clip": ("models.open_clip",
                  lambda m: _fresh(m.OpenCLIP)("ViT-B-32", "laion2b_s34b_b79k"),
                  lambda m: _fresh(m.OpenCLIP)("ViT-B-32", "laion2b_s34b_b79k", device="cpu"),
                  1),
    "owlvit": ("models.owlvit", lambda m: _fresh(m.OWLViT)("google/owlvit-base-patch32"),
               lambda m: _fresh(m.OWLViT)("google/owlvit-base-patch32", device="cpu"), 1),
    "cloob": ("models.cloob", lambda m: _fresh(m.CLOOB)("tiny"),
              lambda m: _fresh(m.CLOOB)("tiny", device="cpu"), 1),
    "blip": ("models.blip", lambda m: _fresh(m.BLIP)("tiny"),
             lambda m: _fresh(m.BLIP)("tiny", device="cpu"), 1),
    "velocity_diffusion": ("models.velocity_diffusion.velocity_diffusion",
                           lambda m: _fresh(m.VelocityDiffusion)("tiny"),
                           lambda m: m.VelocityDiffusion("tiny", device="cpu"), 1),
    "midas_depth": ("models.midas_depth", lambda m: _fresh(m.MidasDepth)("tiny_v21"),
                    lambda m: _fresh(m.MidasDepth)("tiny_v21", device="cpu"), 1),
    "simulacra_aesthetic": ("models.simulacra_aesthetic",
                            lambda m: _fresh(m.SimulacraAesthetic)("ViT-B-32"),
                            lambda m: _fresh(m.SimulacraAesthetic)("ViT-B-32"), 1),
    "slip": ("models.slip", lambda m: _fresh(m.SLIP)("tiny"),
             lambda m: _fresh(m.SLIP)("tiny", device="cpu"), 1),
    "vgg": ("models.vgg", lambda m: _fresh(m.VGG19)(), lambda m: _fresh(m.VGG19)(device="cpu"),
            1),
    "lpips": ("models.lpips", lambda m: _fresh(m.LPIPS)("squeeze"),
              lambda m: _fresh(m.LPIPS)("squeeze", device="cpu"), 2),
    "guided_diffusion": ("models.guided_diffusion.guided_diffusion",
                         lambda m: _fresh(m.GuidedDiffusion)("tiny"),
                         lambda m: m.GuidedDiffusion("tiny", device="cpu"), 1),
    "ruclip": ("models.ruclip", lambda m: _fresh(m.RuCLIP)("ruclip-vit-base-patch32-224"),
               lambda m: _fresh(m.RuCLIP)("ruclip-vit-base-patch32-224", device="cpu"), 1),
    "lit": ("models.lit", lambda m: _fresh(m.LiT)("tiny"),
            lambda m: _fresh(m.LiT)("tiny", device="cpu"), 1),
    "stable_diffusion": ("models.stable_diffusion.stable_diffusion",
                         lambda m: _fresh(m.StableDiffusion)("tiny"),
                         lambda m: m.StableDiffusion("tiny", device="cpu"), 1),
    "latent_text2image": ("models.latent_diffusion.text2image",
                          lambda m: _fresh(m.Text2Image)(tiny=True),
                          lambda m: m.Text2Image(tiny=True, device="cpu"), 1),
    "latent_face": ("models.latent_diffusion.face", lambda m: _fresh(m.Face)(tiny=True),
                    lambda m: m.Face(tiny=True, device="cpu"), 1),
    "latent_super_resolution": ("models.latent_diffusion.super_resolution",
                                lambda m: _fresh(m.SuperResolution)(tiny=True),
                                lambda m: m.SuperResolution(tiny=True, device="cpu"), 1),
    "glide_clip": ("models.glide_clip", lambda m: _fresh(m.GlideCLIP)("tiny"),
                   lambda m: _fresh(m.GlideCLIP)("tiny", device="cpu"), 2),
    "resmem": ("models.resmem", lambda m: _fresh(m.ResMem)("resmem"),
               lambda m: _fresh(m.ResMem)("resmem", device="cpu"), 1),
    "super_resolution": ("models.super_resolution", lambda m: _fresh(m.SuperResolution)("tiny"),
                         lambda m: _fresh(m.SuperResolution)("tiny", device="cpu"), 1),
}


# where the port's wrapper calls `find_checkpoint` when a base class does it
PORT_CALLERS = {
    **dict.fromkeys(("blip", "cloob", "lit", "owlvit", "ruclip", "slip"), "models.dual_encoder"),
    "transformers_openai_clip": "models.open_clip",
    "latent_super_resolution": "models.latent_diffusion.face",
}


def _asked(package, module_name, construct, n_calls, monkeypatch, caller=None):
    module = importlib.import_module(f"{package}.{module_name}")
    calls = []
    monkeypatch.setattr(importlib.import_module(f"{package}.{caller or module_name}"),
                        "find_checkpoint", _recorder(calls, n_calls))
    with pytest.raises(_Asked):
        construct(module)
    return calls


@pytest.mark.parametrize("site", sorted(SITES))
def test_port_wrapper_asks_for_the_jax_names_in_the_jax_order(site, monkeypatch):
    module_name, jax_ctor, port_ctor, n_calls = SITES[site]
    monkeypatch.setattr(jmodels, "CLIP", _clip_stub)
    monkeypatch.setattr(tmodels, "CLIP", _clip_stub)
    jax_calls = _asked("perceptor_tpu", module_name, jax_ctor, n_calls, monkeypatch)
    port_calls = _asked("perceptor_tpu_torch", module_name, port_ctor, n_calls, monkeypatch,
                        PORT_CALLERS.get(site))
    assert port_calls == jax_calls and len(jax_calls) == n_calls


# -- loads --------------------------------------------------------------------------


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    """One cache directory, searched by both packages."""
    monkeypatch.setattr(jcheckpoints, "CACHE_DIRS", (str(tmp_path),))
    monkeypatch.setattr(tcheckpoints, "CACHE_DIRS", (str(tmp_path),))
    return tmp_path


def _refill(params, seed):
    """The tree with every leaf redrawn, so a load is told from the seed."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (0.1 * rng.standard_normal(np.shape(x))).astype(np.float32),
                        params)


def test_sd_tiny_loads_a_jax_params_artifact(cache_dir):
    from perceptor_tpu.models.clip.tokenizer import SimpleTokenizer
    from perceptor_tpu.models.stable_diffusion import StableDiffusion as JSD
    from perceptor_tpu_torch.models.stable_diffusion import StableDiffusion

    jsd = _fresh(JSD)("tiny", fp16=False, tokenizer=SimpleTokenizer(merges=[]))
    jsd.params = _refill(jsd.params, 4)
    jcheckpoints.save_params(str(cache_dir / "stable_diffusion_tiny"), jsd.params)
    sd = StableDiffusion("tiny", fp16=False, device="cpu")
    tokens = np.random.default_rng(0).integers(0, 100, (1, sd.text_config.context_length))
    got = sd.text_encoder(torch.from_numpy(tokens))
    want = jsd.text_encoder.apply({"params": jsd.params["text_encoder"]},
                                  jax.numpy.asarray(tokens, jax.numpy.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    latents = np.random.default_rng(1).standard_normal((1, 4, 8, 8)).astype(np.float32)
    np.testing.assert_allclose(sd.decode(torch.from_numpy(latents)).numpy(),
                               np.asarray(jsd.decode(jax.numpy.asarray(latents))), atol=ATOL)
    # another seed draws other weights: the file, not the seed, set them
    other = StableDiffusion("tiny", fp16=False, device="cpu", seed=5)
    assert torch.equal(other.text_encoder(torch.from_numpy(tokens)), got)


TINY_CLIP = dict(
    embed_dim=16, image_size=(32, 32), patch_size=8, vision_width=24, vision_layers=1,
    vision_heads=2, context_length=12, vocab_size=64, text_width=20, text_layers=1,
    text_heads=2)


def _clip_pair(tmp_path, **port_kwargs):
    from perceptor_tpu.models.clip.configs import CLIPConfig as JCLIPConfig
    from perceptor_tpu_torch.models.clip.configs import CLIPConfig

    return (lambda **kw: _fresh(jmodels.OpenCLIP)("ViT-B-32", "tinyfile", precision="fp32",
                                                  config=JCLIPConfig(**TINY_CLIP), **kw),
            lambda **kw: _fresh(tmodels.OpenCLIP)("ViT-B-32", "tinyfile", precision="fp32",
                                                  config=CLIPConfig(**TINY_CLIP), device="cpu",
                                                  **kw))


def _same_image_encodings(jclip, tclip):
    images = np.random.default_rng(2).random((2, 3, 32, 32)).astype(np.float32)
    np.testing.assert_allclose(tclip.encode_images(torch.from_numpy(images)).numpy(),
                               np.asarray(jclip.encode_images(jax.numpy.asarray(images))),
                               atol=ATOL)


def test_open_clip_loads_an_open_clip_file_by_path_and_a_params_artifact(tmp_path, cache_dir):
    jmake, tmake = _clip_pair(tmp_path)
    source = tmake(seed=9)  # random weights of another seed, in open_clip's names
    path = str(tmp_path / "weights.pt")
    torch.save(source.module.state_dict(), path)
    jclip, tclip = jmake(checkpoint_path=path), tmake(checkpoint_path=path)
    assert all(torch.equal(a, b) for a, b in zip(tclip.module.state_dict().values(),
                                                  source.module.state_dict().values()))
    _same_image_encodings(jclip, tclip)

    jcheckpoints.save_params(str(cache_dir / "open_clip_ViT-B-32_tinyfile"), jclip.params)
    found = tmake()
    assert all(torch.equal(a, b) for a, b in zip(found.module.state_dict().values(),
                                                  source.module.state_dict().values()))


def test_guided_diffusion_and_vgg_load_upstream_torch_files(cache_dir):
    from perceptor_tpu.models.guided_diffusion import GuidedDiffusion as JGuided
    from perceptor_tpu.models.vgg import VGG19 as JVGG19

    source = tmodels.GuidedDiffusion("tiny", fp16=False, device="cpu", seed=3)
    torch.save(source.module.state_dict(), cache_dir / "guided_diffusion_tiny.pt")
    port = tmodels.GuidedDiffusion("tiny", fp16=False, device="cpu")
    jax_model = _fresh(JGuided)("tiny", fp16=False)
    x = np.random.default_rng(3).random((1, *port.shape)).astype(np.float32)
    got = port.predicted_noise(torch.from_numpy(x), torch.tensor([500]))
    want = jax_model.predicted_noise(jax.numpy.asarray(x), jax.numpy.asarray([500]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)

    vgg_source = _fresh(tmodels.VGG19)(device="cpu", seed=4)
    state = {**vgg_source.module.state_dict(), "classifier.0.weight": torch.zeros(2, 2)}
    torch.save(state, cache_dir / "vgg19.pth")
    vgg = _fresh(tmodels.VGG19)(device="cpu")
    assert all(torch.equal(vgg.module.state_dict()[k], v)
               for k, v in vgg_source.module.state_dict().items())
    jvgg = _fresh(JVGG19)()
    images = np.random.default_rng(4).random((1, 3, 32, 32)).astype(np.float32)
    np.testing.assert_allclose(vgg(torch.from_numpy(images)).numpy(),
                               np.asarray(jvgg(jax.numpy.asarray(images))), atol=1e-4)


def test_aesthetic_heads_load_their_upstream_files(cache_dir, monkeypatch):
    monkeypatch.setattr(jmodels, "CLIP", _clip_stub)
    monkeypatch.setattr(tmodels, "CLIP", _clip_stub)
    rng = np.random.default_rng(6)
    ava = {"weight": torch.from_numpy(rng.standard_normal((10, 8)).astype(np.float32)),
           "bias": torch.from_numpy(rng.standard_normal(10).astype(np.float32))}
    torch.save(ava, cache_dir / "ava_vit_b_16.pth")
    jloss = importlib.import_module(
        "perceptor_tpu.losses.aesthetic_visual_assessment").AestheticVisualAssessment()
    tloss = importlib.import_module(
        "perceptor_tpu_torch.losses.aesthetic_visual_assessment").AestheticVisualAssessment()
    assert np.array_equal(tloss.weight.numpy(), np.asarray(jloss.weight))
    assert np.array_equal(tloss.bias.numpy(), np.asarray(jloss.bias))

    probe = {"linear.weight": torch.from_numpy(rng.standard_normal((1, 8)).astype(np.float32)),
             "linear.bias": torch.from_numpy(rng.standard_normal(1).astype(np.float32))}
    torch.save(probe, cache_dir / "simulacra_ViT-B-32.pth")
    jsim = _fresh(jmodels.SimulacraAesthetic)("ViT-B-32")
    tsim = _fresh(tmodels.SimulacraAesthetic)("ViT-B-32")
    assert np.array_equal(tsim.weight.numpy(), np.asarray(jsim.weight))
    assert np.array_equal(tsim.bias.numpy(), np.asarray(jsim.bias))


def test_a_file_of_other_keys_is_refused_loudly(cache_dir):
    torch.save({"not.a.key": torch.zeros(1)}, cache_dir / "guided_diffusion_tiny.pt")
    with pytest.raises(RuntimeError):
        tmodels.GuidedDiffusion("tiny", fp16=False, device="cpu")
