"""The port's `parallel` collectives and `mesh=` samplers across ranks: one
spawned gloo world of 2 ranks and one of 4 (CPU processes, each its own
rank), every case run in it, held against the JAX package's results
computed in this process on the same numpy inputs (JAX on its 8 virtual CPU
devices). The ring, Ulysses (77 keys, padded) and the pipeline forward and
backward, at the shapes and tolerances of JAX's own tests; TINY SD
sampling and `engine.guided_sample` with `mesh=` over tensor=2 and
context=2, at the tolerances the single-device parity tests use. Rank 0
saves what every case gave; the module imports no JAX at its top, since
each rank imports it."""

import datetime
import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)

FWD_ATOL = 1e-5  # tests/test_ring_attention.py, tests/test_ulysses.py
GRAD_ATOL = 1e-4
PIPE_ATOL = 1e-5  # tests/test_pipeline.py, forward and gradients
# tests/test_torch_stable_diffusion.py LOOP_RTOL and tests/test_torch_engine.py
# RTOL: relative L2 of the CFG loop's latents, of the guided latents and losses
LOOP_RTOL = 1e-4
GUIDED_RTOL = 1e-4
# a rank's batch of 1 against the batch of 2 rounds its products otherwise
# (~1e-6), and the first DDIM step's x0 divides by the signal scale at index
# 999 (about 0.07): images in [0, 1] within 1e-3
FAMILY_ATOL = 1e-3
GUIDANCE = dict(guidance_scale=40.0, loss_weights=(1.0, 0.5), clamp_value=1.0)
# a world that has not ended by then is stopped and the fixture fails: a
# rank that skips a collective leaves the others waiting on it
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=120)
WORLD_DEADLINE_S = 240.0


class InRangeTokenizer:
    """Token ids under TINY_TEXT's 128-entry table."""

    sot_token, eot_token = 126, 127

    def encode(self, text):
        return [ord(c) % 126 for c in text]


def _inputs(world):
    rng = np.random.default_rng(20 + world)
    x = {name: rng.standard_normal(shape).astype(np.float32) for name, shape in {
        "q": (2, 4, 64, 32), "k": (2, 4, 64, 32), "v": (2, 4, 64, 32),
        "k77": (2, 4, 77, 32), "v77": (2, 4, 77, 32),
        "pipe_w": (world, 8, 8), "pipe_x": (8, 8),
    }.items()}
    x["pipe_w"] *= 0.3
    x["pipe_b"] = (np.linspace(-0.1, 0.1, world)[:, None] * np.ones((world, 8))).astype(
        np.float32)
    return x


def _losses(target):
    return [lambda images: ((images - target) ** 2).sum(), lambda images: images.mean()]


def _stage_fn(params, x):
    return x + torch.tanh(x @ params["w"] + params["b"])


def _worker(rank, world, port, x, sd_case, out_path):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from perceptor_tpu_torch import parallel

    # a collective that never completes raises after COLLECTIVE_TIMEOUT
    parallel.initialize_distributed(f"localhost:{port}", world, rank, device="cpu",
                                    timeout=COLLECTIVE_TIMEOUT)
    t = {name: torch.from_numpy(value) for name, value in x.items()}
    out = {}
    mesh = parallel.create_mesh(data=1, context=world)

    def value_and_grads(fn, *args):
        args = [a.clone().requires_grad_(True) for a in args]
        value = fn(*args)
        grads = torch.autograd.grad(value.square().sum(), args)
        return value.detach().numpy(), [g.numpy() for g in grads]

    out["ring"] = value_and_grads(lambda *a: parallel.ring_attention(*a, mesh),
                                  t["q"], t["k"], t["v"])
    out["ulysses"] = value_and_grads(lambda *a: parallel.ulysses_attention(*a, mesh),
                                     t["q"], t["k77"], t["v77"])
    stages = parallel.create_mesh(data=1, stage=world)
    value, grads = value_and_grads(
        lambda w, b, h: parallel.pipeline(_stage_fn, {"w": w, "b": b}, h, stages,
                                          n_microbatches=2 * world),
        t["pipe_w"], t["pipe_b"], t["pipe_x"])
    out["pipeline"] = (value, dict(zip("wb", grads)))
    if sd_case is not None:
        out.update(_sd_cases(world, sd_case))
        out["families"] = _family_cases(world)
    if rank == 0:
        torch.save(out, out_path)
    dist.barrier()
    dist.destroy_process_group()


def _sd_cases(world, case):
    from perceptor_tpu_torch import parallel
    from perceptor_tpu_torch.engine import guided_sample
    from perceptor_tpu_torch.models.stable_diffusion import StableDiffusion

    out = {}
    for name, states in (("sample", case["sample_states"]), ("guided", case["guided_states"])):
        sd = StableDiffusion("tiny", fp16=False, device="cpu", tokenizer=InRangeTokenizer())
        sd.load_state_dicts(states)
        for axis in ("tensor", "context"):
            mesh = parallel.create_mesh(data=1, **{axis: world})
            if name == "sample":
                s = case["sample"]
                with parallel.record_routing() as report:
                    out[f"sample_{axis}"] = sd.sample_loop(
                        torch.from_numpy(s["latents"]), s["pairs"],
                        torch.from_numpy(s["uncond"]), torch.from_numpy(s["cond"]), 7.0,
                        mesh=mesh).numpy()
                out[f"routes_{axis}"] = report.routes()
                images = sd.sample(["a red cube"], n_steps=2, size=(16, 16), mesh=mesh)
                out[f"images_{axis}"] = (images - sd.sample(["a red cube"], n_steps=2,
                                                           size=(16, 16))).abs().max().item()
            else:
                g = case["guided"]
                latents, history = guided_sample(
                    sd, _losses(torch.from_numpy(g["target"])), torch.from_numpy(g["latents"]),
                    g["pairs"], conditioning=torch.from_numpy(g["cond"]), mesh=mesh,
                    **GUIDANCE)
                out[f"guided_{axis}"] = (latents.numpy(), history.numpy())
    return out


# the tiny BERT vocabulary of tests/test_torch_latent_diffusion.py
TINY_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "cat", "photo", "of", "##s", "the"]


def _family_cases(world):
    """Every other sampler's `sample(mesh=)` against its own `sample()`, a
    batch of 2 on data=2 (each rank its row), tensor=2 and context=2,
    deterministic (eta 0): {model: {mesh: max abs difference}}."""
    from perceptor_tpu_torch import parallel
    from perceptor_tpu_torch.models.guided_diffusion import GuidedDiffusion
    from perceptor_tpu_torch.models.latent_diffusion import Face, SuperResolution, Text2Image
    from perceptor_tpu_torch.models.latent_diffusion.bert import BERTTokenizer
    from perceptor_tpu_torch.models.velocity_diffusion import VelocityDiffusion

    tokenizer = BERTTokenizer(vocab=TINY_VOCAB, max_length=16)
    lr = torch.rand((2, 3, 16, 16), generator=torch.Generator().manual_seed(4))
    runs = {
        "guided_diffusion": (GuidedDiffusion("tiny", fp16=False, device="cpu"),
                             dict(n_images=2, n_steps=2)),
        "velocity_diffusion": (VelocityDiffusion("tiny", fp16=False, device="cpu"),
                               dict(n_images=2, n_steps=2)),
        "text2image": (Text2Image(fp16=False, tiny=True, guidance_scale=3.0, device="cpu",
                                  tokenizer=tokenizer),
                       dict(texts=["a cat", "the photo"], negative_texts=["", ""], n_steps=2,
                            size=(16, 16), eta=0.0)),
        "face": (Face(fp16=False, tiny=True, device="cpu"),
                 dict(n_images=2, n_steps=2, size=(16, 16), eta=0.0)),
        "super_resolution": (SuperResolution(fp16=False, tiny=True, device="cpu"),
                             dict(images=lr, n_steps=2, eta=0.0)),
    }
    out = {}
    for name, (model, kwargs) in runs.items():
        want = model.sample(**kwargs, generator=torch.Generator().manual_seed(1))
        out[name] = {}
        for axis in ("data", "tensor", "context"):
            mesh = parallel.create_mesh(**{"data": 1, axis: world})
            got = model.sample(**kwargs, generator=torch.Generator().manual_seed(1), mesh=mesh)
            out[name][axis] = (tuple(got.shape) == tuple(want.shape),
                               float((got - want).abs().max()))
    return out


def _start_world(world, x, sd_case, out_path):
    """The spawned world's processes, started; `.join()` waits for them."""
    from perceptor_tpu_torch.parallel.mesh import free_port

    port = free_port()
    return mp.start_processes(_worker, args=(world, port, x, sd_case, out_path), nprocs=world,
                              join=False, start_method="spawn")


def _fill_params(params, seed):
    import jax
    import jax.numpy as jnp

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


def _sd_inputs():
    """The TINY SD weights (the JAX tiny model's params re-drawn, seeds 0
    and 1) and inputs of the sampling and guided cases."""
    import jax

    from perceptor_tpu.models.clip.tokenizer import SimpleTokenizer
    from perceptor_tpu.models.stable_diffusion import StableDiffusion as JStableDiffusion
    from perceptor_tpu.models.stable_diffusion import config as jsd_config
    from perceptor_tpu_torch import convert
    from perceptor_tpu_torch.schedules import indexed_schedule
    from perceptor_tpu_torch.schedules.ddpm import scaled_linear_alphas_sigmas

    models = []
    for seed in (0, 1):
        model = JStableDiffusion.__wrapped__("tiny", fp16=False,
                                             tokenizer=SimpleTokenizer(merges=[]))
        model.params = _fill_params(model.params, seed=seed)
        models.append(model)

    def states(model):
        return convert.stable_diffusion_state_dicts_from_jax(
            jax.tree.map(np.asarray, model.params), jsd_config.TINY_UNET, jsd_config.TINY_VAE,
            jsd_config.TINY_TEXT)

    cfg = jsd_config.TINY_TEXT
    rng = np.random.default_rng(33)
    alphas, sigmas = scaled_linear_alphas_sigmas()
    text = (1, cfg.context_length, cfg.width)
    sample = {"latents": rng.standard_normal((1, 4, 8, 8)).astype(np.float32),
              "uncond": rng.standard_normal(text).astype(np.float32),
              "cond": rng.standard_normal(text).astype(np.float32),
              "pairs": indexed_schedule(alphas, sigmas, n_steps=4, strict=False)}
    guided = {"latents": rng.standard_normal((1, 4, 8, 8)).astype(np.float32),
              "cond": rng.standard_normal(text).astype(np.float32),
              "target": rng.uniform(size=(1, 3, 16, 16)).astype(np.float32),
              "pairs": indexed_schedule(alphas, sigmas, n_steps=3, from_index=700,
                                        strict=False)}
    case = {"sample_states": states(models[0]), "guided_states": states(models[1]),
            "sample": sample, "guided": guided}
    return models, case


def _jax_sd(models, case):
    """JAX's TINY SD runs with mesh= over tensor=2 and context=2."""
    import jax
    import jax.numpy as jnp

    from perceptor_tpu import parallel as jparallel
    from perceptor_tpu.engine import guided_sample as j_guided_sample

    jsd, jg = models
    sample, guided = case["sample"], case["guided"]
    want = {}
    for axis in ("tensor", "context"):
        mesh = jparallel.create_mesh(data=1, **{axis: 2}, devices=jax.devices()[:2])
        want[f"sample_{axis}"] = np.asarray(jsd._sample_scan(
            jparallel.shard_params(jsd.params, mesh), jnp.asarray(sample["latents"]),
            jnp.asarray(sample["pairs"]), jnp.asarray(sample["uncond"]),
            jnp.asarray(sample["cond"]), 7.0, 0.0, jax.random.PRNGKey(0), mesh=mesh))
        latents, history = j_guided_sample(
            jg, _losses(jnp.asarray(guided["target"])), jnp.asarray(guided["latents"]),
            guided["pairs"], conditioning=jnp.asarray(guided["cond"]), mesh=mesh, **GUIDANCE)
        want[f"guided_{axis}"] = (np.asarray(latents), np.asarray(history))
    return want


def _jax_collectives(world, x):
    import jax
    import jax.numpy as jnp

    from perceptor_tpu import parallel as jparallel
    from perceptor_tpu.parallel.pipeline import pipeline as j_pipeline

    j = {name: jnp.asarray(value) for name, value in x.items()}
    mesh = jparallel.create_mesh(data=1, context=world, devices=jax.devices()[:world])
    stages = jparallel.create_mesh(data=1, stage=world, devices=jax.devices()[:world])

    def value_and_grads(fn, *args):
        def loss(*a):
            value = fn(*a)
            return jnp.sum(jnp.square(value)), value

        argnums = tuple(range(len(args)))
        (_, value), grads = jax.jit(jax.value_and_grad(loss, argnums, has_aux=True))(*args)
        return np.asarray(value), [np.asarray(g) for g in grads]

    def stage_fn(params, h):
        return h + jnp.tanh(h @ params["w"] + params["b"])

    value, grads = value_and_grads(
        lambda w, b, h: j_pipeline(stage_fn, {"w": w, "b": b}, h, stages,
                                   n_microbatches=2 * world),
        j["pipe_w"], j["pipe_b"], j["pipe_x"])
    return {
        "ring": value_and_grads(lambda *a: jparallel.ring_attention(*a, mesh),
                                j["q"], j["k"], j["v"]),
        "ulysses": value_and_grads(lambda *a: jparallel.ulysses_attention(*a, mesh),
                                   j["q"], j["k77"], j["v77"]),
        "pipeline": (value, dict(zip("wb", grads))),
    }


def _rel_l2(got, want):
    return float(np.linalg.norm(np.asarray(got) - want) / np.linalg.norm(want))


def _join(processes, world):
    """Wait for the world's processes until WORLD_DEADLINE_S; past it, stop
    them and fail. A rank that raised fails the join at once."""
    deadline = time.monotonic() + WORLD_DEADLINE_S
    while not processes.join(timeout=5):
        if time.monotonic() > deadline:
            for process in processes.processes:
                if process.is_alive():
                    process.terminate()
            for process in processes.processes:
                process.join(timeout=10)
            pytest.fail(f"the gloo world of {world} ranks did not end in {WORLD_DEADLINE_S} s")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{world: (port results of rank 0, JAX results)}, one world per size;
    the worlds run while this process computes JAX's results."""
    directory = str(tmp_path_factory.mktemp("gloo"))
    inputs = {world: _inputs(world) for world in (2, 4)}
    models, sd_case = _sd_inputs()
    out = {}
    for world in (2, 4):
        path = os.path.join(directory, f"world{world}.pt")
        processes = _start_world(world, inputs[world], sd_case if world == 2 else None, path)
        want = _jax_collectives(world, inputs[world])
        if world == 2:
            want.update(_jax_sd(models, sd_case))
        _join(processes, world)
        out[world] = (torch.load(path, weights_only=False), want)
    return out


def _close(got, want, atol):
    value, grads = got
    j_value, j_grads = want
    assert value.shape == j_value.shape
    np.testing.assert_allclose(value, j_value, atol=FWD_ATOL if atol != PIPE_ATOL else atol)
    names = list(j_grads) if isinstance(j_grads, dict) else range(len(j_grads))
    for name in names:
        np.testing.assert_allclose(grads[name], j_grads[name], atol=atol, err_msg=str(name))


@pytest.mark.parametrize("world", [2, 4])
def test_ring_attention_across_ranks_matches_jax(results, world):
    got, want = results[world]
    _close(got["ring"], want["ring"], GRAD_ATOL)


@pytest.mark.parametrize("world", [2, 4])
def test_ulysses_attention_with_77_padded_keys_matches_jax(results, world):
    got, want = results[world]
    assert got["ulysses"][0].shape == (2, 4, 64, 32)
    _close(got["ulysses"], want["ulysses"], GRAD_ATOL)


@pytest.mark.parametrize("world", [2, 4])
def test_pipeline_across_ranks_matches_jax(results, world):
    got, want = results[world]
    assert set(got["pipeline"][1]) == {"w", "b"}
    _close(got["pipeline"], want["pipeline"], PIPE_ATOL)


@pytest.mark.parametrize("axis", ["tensor", "context"])
def test_sd_sample_with_a_mesh_matches_jax(results, axis):
    got, want = results[2]
    assert _rel_l2(got[f"sample_{axis}"], want[f"sample_{axis}"]) <= LOOP_RTOL
    # the plan routes the TINY UNet's attention through Ulysses (heads 2
    # divide the context axis) and records the replicated activations at the
    # entry as a fallback; without one every site takes the plain route
    assert set(got[f"routes_{axis}"]) == ({"ulysses", None} if axis == "context"
                                          else {"xla"})
    assert got[f"images_{axis}"] <= 1e-5  # sample(mesh=) against sample()


@pytest.mark.parametrize("family", ["guided_diffusion", "velocity_diffusion", "text2image",
                                    "face", "super_resolution"])
def test_every_sampler_with_a_mesh_matches_its_unsharded_run(results, family):
    """data=2 shards the batch of 2 (each rank samples its row), tensor=2
    places the weights, context=2 routes the attention: the images agree
    with the single-device run to FAMILY_ATOL (summation order only)."""
    got, _ = results[2]
    for axis, (same_shape, diff) in got["families"][family].items():
        assert same_shape and diff <= FAMILY_ATOL, (axis, diff)


@pytest.mark.parametrize("axis", ["tensor", "context"])
def test_guided_sample_with_a_mesh_matches_jax(results, axis):
    got, want = results[2]
    latents, history = got[f"guided_{axis}"]
    j_latents, j_history = want[f"guided_{axis}"]
    assert _rel_l2(latents, j_latents) <= GUIDED_RTOL
    assert _rel_l2(history, j_history) <= GUIDED_RTOL
