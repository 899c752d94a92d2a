"""Stable Diffusion XL in the port against the benchmark's plain reference
(`benchmark/reference/sdxl_unet.py`, `sdxl_pipeline.py`), at the tiny SDXL
size on the CPU in float32: the UNet (depth (0, 1, 2) by level, heads of
width 8, linear projections, the added embedding), both text towers
(penultimate states, the pooled projection), `conditioning` with zeros for
the unconditional half, a whole `sample` call, the converters from
diffusers / HF names, a diffusers pipeline file, the paths that refuse
SDXL, and the spans."""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import registry  # noqa: E402
from benchmark.harness.weights import draw  # noqa: E402
from benchmark.reference import sdxl_pipeline  # noqa: E402
from benchmark.reference.sdxl_unet import SDXLUNet  # noqa: E402
from perceptor_tpu_torch.convert import text_encoder_state_dict_from_hf  # noqa: E402
from perceptor_tpu_torch.models.stable_diffusion import StableDiffusion, UNet  # noqa: E402
from perceptor_tpu_torch.models.stable_diffusion import config as sd_config  # noqa: E402
from perceptor_tpu_torch.models.stable_diffusion.text_encoder import (  # noqa: E402
    CLIPTextEncoder,
)
from perceptor_tpu_torch.utils import profiling  # noqa: E402

import test_torch_cpu_guard  # noqa: E402,F401  (the first-call torch.exp guard)

CONFIG = registry.load_json(registry.BENCH_DIR / "tests" / "configs" / "tiny_sdxl.json")
VOCAB = CONFIG["text_encoder"]["vocab_size"]  # CLIP's, so the real tokenizer serves both sides
MIX = {"size": 32, "steps": 3, "rho": 7.0, "guidance_scale": 5.0}
PROMPTS = ["a painting of a fox under a castle", "robot"]


def close(got, want, tol=1e-5):
    got, want = got.double(), want.double()
    err = float(torch.linalg.norm(got - want) / torch.clamp(torch.linalg.norm(want), min=1e-30))
    assert err <= tol, err


def weights(seed=5):
    return {part: draw(cls, CONFIG[part], seed, part, "cpu")
            for part, cls in sdxl_pipeline.PARTS.items()}


def port_states(states, sd):
    out = dict(states)
    for part, cfg in (("text_encoder", sd.text_config), ("text_encoder_2", sd.text_config_2)):
        out[part] = text_encoder_state_dict_from_hf(states[part], cfg)
    return out


@pytest.fixture
def real_vocab(monkeypatch):
    for name in ("TINY_XL_TEXT", "TINY_XL_TEXT_2"):
        monkeypatch.setattr(sd_config, name,
                            dataclasses.replace(getattr(sd_config, name), vocab_size=VOCAB))


@pytest.fixture
def pair(real_vocab):
    """(the port's tiny SDXL, the reference) on the same seeded weights."""
    states = weights()
    sd = StableDiffusion("tiny-xl", fp16=False, device="cpu")
    sd.load_state_dicts(port_states(states, sd))
    return sd, sdxl_pipeline.Txt2ImgXLReference(CONFIG, states, "cpu")


def test_unet_matches_the_reference():
    state = draw(SDXLUNet, CONFIG["unet"], 3, "unet", "cpu")
    ref = SDXLUNet(CONFIG["unet"])
    ref.load_state_dict({k: v.float() for k, v in state.items()})
    port = UNet(sd_config.TINY_XL_UNET)
    port.load_state_dict(state)  # diffusers' names, strict
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(3, 4, 16, 16, generator=gen)
    t = torch.tensor([999.0, 500.0, 3.0])
    context = torch.randn(3, 7, 80, generator=gen)
    pooled = torch.randn(3, 40, generator=gen)
    ids = torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024], [512, 768, 0, 0, 512, 768],
                        [32, 32, 4, 8, 32, 32]])
    with torch.no_grad():
        want = ref(x, t, context, pooled, ids)
        close(port(x, t, context, added=(pooled, ids)), want)
        # the added embedding takes part: other size ids, another output
        other = port(x, t, context, added=(pooled, ids.flip(0)))
    assert float((other - want).abs().max()) > 1e-3
    depths = [len(m.transformer_blocks) for m in port.modules() if hasattr(m, "transformer_blocks")]
    # one resnet a down level, two an up level: down 1, 2; mid 2; up 2, 2, 1, 1
    assert sorted(depths) == [1, 1, 1, 2, 2, 2, 2]
    with pytest.raises(ValueError, match="added"):
        port(x, t, context)


@pytest.mark.parametrize("part", ["text_encoder", "text_encoder_2"])
def test_text_towers_penultimate_states_and_pooled_projection(part):
    cfg = dataclasses.replace(
        sd_config.TINY_XL_TEXT if part == "text_encoder" else sd_config.TINY_XL_TEXT_2,
        vocab_size=VOCAB)
    state = draw(sdxl_pipeline.CLIPTextModelWithProjection, CONFIG[part], 4, part, "cpu")
    ref = sdxl_pipeline.CLIPTextModelWithProjection(CONFIG[part])
    ref.load_state_dict({k: v.float() for k, v in state.items()})
    port = CLIPTextEncoder(cfg)
    port.load_state_dict(text_encoder_state_dict_from_hf(state, cfg))
    tokens = torch.randint(1, 40000, (3, 16), generator=torch.Generator().manual_seed(1))
    tokens[:, 0] = 49406
    tokens[0, 9], tokens[0, 10:] = 49407, 0  # end of text, then padding
    tokens[1, 15] = 49407
    tokens[2, 4], tokens[2, 5:] = 49407, 0
    with torch.no_grad():
        states, pooled = port.encode(tokens)
        ref_states, ref_pooled = ref(tokens)
        close(states, ref_states)
        # the penultimate layer's states, not the final LayerNorm's
        assert float((states - ref.text_model.final_layer_norm(ref_states)).abs().max()) > 0.1
    if part == "text_encoder":
        assert pooled is None and ref_pooled is None
    else:
        close(pooled, ref_pooled)
        assert pooled.shape == (3, 40)


def test_conditioning_has_zero_unconditional_half(pair):
    sd, ref = pair
    cond = sd.conditioning(PROMPTS, size=(32, 32))
    context2, pooled2, ids2 = ref.conditioning2(PROMPTS, 32)
    close(cond.encodings, context2[2:])
    close(cond.pooled, pooled2[2:])
    assert torch.equal(cond.size_ids, ids2[2:])
    assert torch.equal(sd.conditioning(PROMPTS).size_ids[0],
                       torch.tensor([1024.0, 1024, 0, 0, 1024, 1024]))
    _, uncond, cond, *_ = sd._setup(PROMPTS, None, 3, (32, 32), None)
    assert torch.count_nonzero(uncond.encodings) == 0 and torch.count_nonzero(uncond.pooled) == 0
    assert torch.equal(uncond.size_ids, cond.size_ids)
    # a negative prompt is encoded, not zeroed
    _, negative, *_ = sd._setup(PROMPTS, ["", "blurry"], 3, (32, 32), None)
    assert torch.count_nonzero(negative.encodings) > 0


def test_sample_matches_the_reference(pair):
    sd, ref = pair
    record = {}

    def unet_hook(module, args, kwargs, out):
        record.setdefault("unet", []).append(out)
        record["added"] = kwargs["added"]

    handle = sd.unet.register_forward_hook(unet_hook, with_kwargs=True)
    try:
        images = sd.sample(PROMPTS, n_steps=MIX["steps"], guidance_scale=MIX["guidance_scale"],
                           size=(32, 32), generator=torch.Generator().manual_seed(11))
    finally:
        handle.remove()
    want = ref.sample(PROMPTS, 11, MIX)
    assert len(record["unet"]) == len(want["unet_out"]) == 3
    assert record["unet"][0].shape[0] == 2 * len(PROMPTS)  # one batched CFG call
    for got, expected in zip(record["unet"], want["unet_out"]):
        close(got, expected)
    close(record["added"][0], want["pooled2"])
    close(images, want["images"])


def test_state_dict_names_round_trip_from_diffusers_and_hf(real_vocab):
    states = weights(6)
    sd = StableDiffusion("tiny-xl", fp16=False, device="cpu")
    converted = port_states(states, sd)
    for part in sd.parts:
        assert set(converted[part]) == set(getattr(sd, part).state_dict()), part
    assert converted["text_encoder_2"]["text_projection"].shape == (48, 40)
    assert torch.equal(converted["text_encoder_2"]["text_projection"],
                       states["text_encoder_2"]["text_projection.weight"].t())
    sd.load_state_dicts(converted)
    for part in ("unet", "vae"):  # diffusers' names are the port's
        for name, value in getattr(sd, part).state_dict().items():
            assert torch.equal(value, states[part][name].float()), name


def test_load_upstream_reads_a_diffusers_sdxl_pipeline_file(tmp_path, real_vocab):
    states = weights(7)
    flat = {f"{part}.{k}": v for part, state in states.items() for k, v in state.items()}
    torch.save(flat, tmp_path / "sdxl.pt")
    sd = StableDiffusion("tiny-xl", fp16=False, device="cpu")
    sd._load_upstream(torch.load(tmp_path / "sdxl.pt"))
    ref = sdxl_pipeline.Txt2ImgXLReference(CONFIG, states, "cpu")
    cond = sd.conditioning(PROMPTS, size=(32, 32))
    context2, pooled2, _ = ref.conditioning2(PROMPTS, 32)
    close(cond.encodings, context2[2:])
    close(cond.pooled, pooled2[2:])
    with pytest.raises(ValueError, match="tiny-xl"):
        sd._load_upstream({"model.diffusion_model.conv_in.weight": torch.zeros(1)})


REFUSED = {
    "export_sample": lambda sd: sd.export_sample(batch=1, size=(32, 32), n_steps=2),
    "export_conditioning": lambda sd: sd.export_conditioning(),
    "deepcache": lambda sd: sd.sample(["a"], n_steps=2, size=(32, 32), cache_interval=2),
    "inpainting": lambda sd: sd.sample(["a"], n_steps=2, size=(32, 32),
                                       inpainting_masks=torch.zeros(1, 1, 32, 32),
                                       init_images=torch.zeros(1, 3, 32, 32)),
    "mesh": lambda sd: sd.sample(["a"], n_steps=2, size=(32, 32), mesh=object()),
}


@pytest.mark.parametrize("path", sorted(REFUSED))
def test_paths_not_extended_to_sdxl_raise(path, real_vocab):
    sd = StableDiffusion("tiny-xl", fp16=False, device="cpu")
    with pytest.raises(ValueError, match="tiny-xl"):
        REFUSED[path](sd)


def test_spans_name_the_towers_and_the_spatial_transformers(real_vocab):
    sd = StableDiffusion("tiny-xl", fp16=False, device="cpu")
    profiling.clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        sd.sample(["a cat"], n_steps=1, size=(32, 32))
    spans = profiling.spans()
    encodes = [r for r in spans if r.name == "text_encode"]
    assert [r.ids["tower"] for r in encodes] == [0, 1] and all(r.ids["rows"] == 1
                                                              for r in encodes)
    blocks = [r for r in spans if r.name == "spatial_transformer"]
    assert len(blocks) == 7 and all(r.parent == "unet" and r.ids["rows"] == 2 for r in blocks)
    assert sorted({(r.ids["depth"], r.ids["tokens"]) for r in blocks}) == [(1, 64), (2, 16)]
    (added,) = [r for r in spans if r.name == "unet"]
    assert added.parent == "sampler_step"


def test_sd1_spatial_transformer_span_off_the_profiler_costs_no_record():
    sd = StableDiffusion("tiny", fp16=False, device="cpu")
    profiling.clear_spans()
    x = torch.randn(2, 4, 8, 8)
    with torch.no_grad():
        sd.unet(x, torch.tensor([10.0, 20.0]), torch.randn(2, 16, 32))
    assert profiling.spans() == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad():
            sd.unet(x, torch.tensor([10.0, 20.0]), torch.randn(2, 16, 32))
    blocks = [r for r in profiling.spans() if r.name == "spatial_transformer"]
    assert len(blocks) == 4 and {r.ids["depth"] for r in blocks} == {1}
