"""The port's converter CLI (`python -m perceptor_tpu_torch.convert`) on the
CPU: the canonical basenames are JAX's for every family and default name;
the CLI end to end at TINY size (a JAX params-v1 artifact in, the port's
artifact out, which the port's wrapper then finds and loads with no key
map); the wrapper is built past its memo; and the artifact, written where
the JAX package searches too, is invisible to it (its wrappers keep their
own weights), because the port writes `<basename>.torch.pt`, a suffix JAX
never tries."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)
from perceptor_tpu import convert as jconvert
from perceptor_tpu.utils import checkpoints as jcheckpoints
from perceptor_tpu_torch import convert
from perceptor_tpu_torch.utils import checkpoints as tcheckpoints

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("family", convert.FAMILIES)
def test_canonical_basenames_and_defaults_are_jax(family):
    assert convert.FAMILIES == jconvert._FAMILIES
    assert convert.DEFAULT_NAMES[family] == jconvert._DEFAULT_NAMES[family]
    for name in {convert.DEFAULT_NAMES[family], "tiny", "a/b"}:
        if family == "open-clip" and "/" not in name:
            name = f"{name}/weights"
        assert convert.canonical_basename(family, name) == jconvert.canonical_basename(family, name)


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(jcheckpoints, "CACHE_DIRS", (str(tmp_path / "cache"),))
    monkeypatch.setattr(tcheckpoints, "CACHE_DIRS", (str(tmp_path / "cache"),))
    (tmp_path / "cache").mkdir()
    return tmp_path / "cache"


def _jax_sd():
    from perceptor_tpu.models.clip.tokenizer import SimpleTokenizer
    from perceptor_tpu.models.stable_diffusion import StableDiffusion

    return StableDiffusion.__wrapped__("tiny", fp16=False, tokenizer=SimpleTokenizer(merges=[]))


def test_cli_end_to_end_at_tiny_and_invisible_to_jax(tmp_path, cache_dir, capsys):
    from perceptor_tpu_torch.models.stable_diffusion import StableDiffusion

    jsd = _jax_sd()
    rng = np.random.default_rng(12)
    jsd.params = jax.tree.map(lambda x: (0.1 * rng.standard_normal(np.shape(x))).astype(
        np.float32), jsd.params)
    source = str(tmp_path / "jax_tiny.npz")
    jcheckpoints.save_params(source, jsd.params)
    out = str(cache_dir / convert.canonical_basename("stable-diffusion", "tiny"))
    assert convert.main([source, "--family", "stable-diffusion", "--name", "tiny", "--out", out,
                         "--device", "cpu"]) == 0
    written = out + tcheckpoints.PORT_SUFFIX
    assert f"wrote {written}" in capsys.readouterr().out
    assert sorted(os.listdir(cache_dir)) == [os.path.basename(written)]

    # the port finds it and loads it as it stands: the same tensors as a
    # conversion of the JAX params
    sd = StableDiffusion("tiny", fp16=False, device="cpu")
    want = convert.stable_diffusion_state_dicts_from_jax(
        jax.tree.map(np.asarray, jsd.params), sd.unet_config, sd.vae_config, sd.text_config)
    for part, state in want.items():
        own = getattr(sd, part).state_dict()
        assert all(torch.equal(own[k], v.float()) for k, v in state.items())
    artifact = torch.load(written, weights_only=True)
    assert artifact[tcheckpoints.PORT_FORMAT_KEY] == tcheckpoints.PORT_FORMAT
    assert sorted(artifact["modules"]) == ["text_encoder", "unet", "vae"]

    # the JAX package, searching the same directory, does not see it
    assert jcheckpoints.find_checkpoint("stable_diffusion_tiny", "tiny") is None
    fresh = _jax_sd()
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(fresh.params),
                                                     jax.tree.leaves(_jax_sd().params)))


def test_cli_builds_the_wrapper_past_its_memo(tmp_path, cache_dir, monkeypatch):
    from perceptor_tpu_torch.models import open_clip
    from perceptor_tpu_torch.models.clip.configs import CLIPConfig

    tiny = CLIPConfig(embed_dim=16, image_size=(32, 32), patch_size=8, vision_width=24,
                      vision_layers=1, vision_heads=2, context_length=12, vocab_size=64,
                      text_width=20, text_layers=1, text_heads=2)
    monkeypatch.setattr(open_clip.clip_configs, "get_config", lambda arch, weights: tiny)
    # the memo holds a seed-0 instance under the arguments the CLI builds with
    memoized = open_clip.OpenCLIP("ViT-B-32", "cli", precision="fp32", device="cpu")
    seed0 = {k: v.clone() for k, v in memoized.module.state_dict().items()}
    source_model = open_clip.OpenCLIP.__wrapped__("ViT-B-32", "cli", precision="fp32",
                                                  device="cpu", seed=3)
    source = str(tmp_path / "open_clip.pt")
    torch.save(source_model.module.state_dict(), source)

    out = convert.convert(source, "open-clip", "ViT-B-32/cli", str(cache_dir / "x"), "cpu")
    modules = torch.load(out, weights_only=True)["modules"]
    assert all(torch.equal(modules["module"][k], v)
               for k, v in source_model.module.state_dict().items())
    # the memoized instance was neither used nor changed
    again = open_clip.OpenCLIP("ViT-B-32", "cli", precision="fp32", device="cpu")
    assert again is memoized
    assert all(torch.equal(memoized.module.state_dict()[k], v) for k, v in seed0.items())


def test_cli_runs_as_a_module_without_jax():
    code = ("import sys, runpy\n"
            "sys.argv = ['convert', '--help']\n"
            "try:\n"
            "    runpy.run_module('perceptor_tpu_torch.convert', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'perceptor_tpu'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "--family" in proc.stdout and "stable-diffusion" in proc.stdout
