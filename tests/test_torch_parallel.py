"""The port's `parallel` package against the JAX package's, in one process:
the context-parallel routing rules and their reasons, the tensor-parallel
partition of the TINY SD UNet, the routing report of a TINY UNet under a
2-rank context plan, and the collective inventory of the traced ring and
Ulysses programs. The port's meshes live in a fake process group of 8
ranks (`torch.testing._internal.distributed.fake_pg`: collectives are
no-ops, so programs trace but nothing is computed across ranks); JAX's on
its 8 virtual CPU devices. Multi-rank numerics are `test_torch_distributed.py`'s."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.fx.experimental.proxy_tensor import make_fx

from perceptor_tpu import parallel as jparallel
from perceptor_tpu.models.clip.tokenizer import SimpleTokenizer
from perceptor_tpu.models.stable_diffusion import StableDiffusion as JStableDiffusion
from perceptor_tpu.models.stable_diffusion import config as jsd_config
from perceptor_tpu.utils import hlo as jhlo
from perceptor_tpu_torch import convert, parallel
from perceptor_tpu_torch.models.stable_diffusion import StableDiffusion
from perceptor_tpu_torch.parallel import partition
from perceptor_tpu_torch.utils import hlo

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)

WORLD = 8


@pytest.fixture(scope="module")
def world():
    """A fake process group of 8 ranks, this process rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=WORLD)
    yield WORLD
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def models():
    jsd = JStableDiffusion.__wrapped__("tiny", fp16=False, tokenizer=SimpleTokenizer(merges=[]))
    sd = StableDiffusion("tiny", fp16=False, device="cpu")
    sd.load_state_dicts(convert.stable_diffusion_state_dicts_from_jax(
        jax.tree.map(np.asarray, jsd.params), jsd_config.TINY_UNET, jsd_config.TINY_VAE,
        jsd_config.TINY_TEXT))
    return jsd, sd


def _meshes(**axes):
    return (jparallel.create_mesh(data=-1, **axes), parallel.create_mesh(data=-1, **axes))


# -- the routing rules --------------------------------------------------------


GRID = list(itertools.product(
    (64, 100, 1024, 1030, 2048, 4096, 8192), (77, 1024, 2048, 4096, 8192), (1, 5, 8), (False, True)))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_route_explain_matches_jax_string_for_string(world, n):
    jmesh, mesh = _meshes(context=n)
    jplan, plan = jparallel.plan_for_mesh(jmesh), parallel.plan_for_mesh(mesh)
    assert plan.n_context == jplan.n_context == n
    for seq_q, seq_k, heads, masked in GRID + [(s, s, h, False) for s in (64, 1024, 8192)
                                                for h in (1, 5, 8)]:
        assert plan.route_explain(seq_q, seq_k, heads, masked) == \
            jplan.route_explain(seq_q, seq_k, heads, masked), (seq_q, seq_k, heads, masked)
        assert plan.route(seq_q, seq_k, heads, masked) == jplan.route(seq_q, seq_k, heads, masked)


def test_plan_for_mesh_and_spatial_spec(world):
    from torch.distributed.tensor import Replicate, Shard

    assert parallel.plan_for_mesh(None) is None
    assert parallel.plan_for_mesh(parallel.create_mesh(data=-1)) is None
    jmesh, mesh = _meshes(context=2)
    plan = parallel.plan_for_mesh(mesh)
    # JAX: P("data", None, "context", None) for a batch of 4 on data=4
    assert tuple(jparallel.plan_for_mesh(jmesh).spatial_spec(4, 2, 4)) == \
        ("data", None, "context", None)
    assert plan.spatial_spec(4, 2, 4) == [Shard(0), Replicate(), Shard(2), Replicate()]
    assert plan.spatial_spec(4, 2, 3) == [Replicate(), Replicate(), Shard(2), Replicate()]
    assert parallel.current_plan() is None
    with parallel.context_parallel(mesh) as active:
        assert parallel.current_plan() is active
    assert parallel.current_plan() is None


def test_flash_route_is_false_where_the_plan_takes_the_shape(world, monkeypatch):
    import importlib

    tattn = importlib.import_module("perceptor_tpu_torch.ops.attention")
    monkeypatch.setattr(tattn.torch.cuda, "is_available", lambda: True)
    assert tattn.flash_route(4096, 4096)
    with parallel.context_parallel(parallel.create_mesh(data=-1, context=2)):
        assert not tattn.flash_route(4096, 4096)  # the ring takes it
    with parallel.context_parallel(parallel.create_mesh(data=-1, context=8)):
        assert not tattn.flash_route(4096, 4096)  # shard 512: the comm-bound ring
    assert tattn.flash_route(4096, 4096)


# -- the tensor-parallel partition --------------------------------------------


def _tagged(params, specs):
    """Each leaf i as i * 10000 plus, along the dim its spec shards, the
    index on that dim: after conversion a port tensor names its JAX leaf
    and the dim it varies along."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    spec_leaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    tagged, sharded = [], []
    for i, (leaf, spec) in enumerate(zip(leaves, spec_leaves)):
        shape = np.shape(leaf)
        out = np.full(shape, i * 10000.0, np.float32)
        dims = [d for d, axis in enumerate(spec) if axis is not None]
        if dims:
            d = dims[0]
            index = np.arange(shape[d], dtype=np.float32).reshape(
                [-1 if k == d else 1 for k in range(len(shape))])
            out = out + index
        tagged.append(out)
        sharded.append(bool(dims))
    return jax.tree_util.tree_unflatten(treedef, tagged), sharded


@pytest.mark.parametrize("tensor", [2, 4])
def test_partition_shards_the_same_logical_axis_as_jax(world, models, tensor):
    """For every parameter of the TINY SD UNet: the port shards the dim that
    holds JAX's sharded axis after conversion, or replicates where JAX does
    (a sharded dim that does not divide by the axis is replicated by
    both)."""
    jsd, sd = models
    jmesh, mesh = _meshes(tensor=tensor)
    jspecs = jparallel.partition_params(jsd.params, jparallel.SD_TENSOR_PARALLEL_RULES, jmesh)
    tagged, sharded = _tagged(jsd.params, jspecs)
    unet = convert.stable_diffusion_state_dicts_from_jax(
        tagged, jsd_config.TINY_UNET, jsd_config.TINY_VAE, jsd_config.TINY_TEXT)["unet"]
    specs = partition.partition_params({"unet": unet}, parallel.SD_TENSOR_PARALLEL_RULES,
                                       mesh)["unet"]
    assert set(specs) == set(unet) == {n for n, _ in sd.unet.named_parameters()}
    n_sharded = 0
    for name, tensor_ in unet.items():
        values = tensor_.double().numpy()
        leaf = int(np.floor(values.min() / 10000))
        assert np.floor(values.max() / 10000) == leaf, name
        offset = values - leaf * 10000
        varying = [d for d in range(values.ndim) if values.shape[d] > 1
                   and np.ptp(offset, axis=d).max() > 0]
        spec = specs[name]
        ported = [d for d, axis in enumerate(spec) if axis is not None]
        if sharded[leaf]:
            n_sharded += 1
            assert len(varying) == 1 and ported == varying, (name, spec, varying)
        else:
            assert ported == [], (name, spec)
    assert n_sharded > 20


def test_shard_params_places_dtensors_by_the_rules(world):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = parallel.create_mesh(data=-1, tensor=2)
    params = {"blk": {"attn.to_q.weight": torch.ones(8, 4), "attn.to_out.0.weight": torch.ones(4, 8),
                      "attn.to_out.0.bias": torch.ones(4), "conv1.weight": torch.ones(5, 4, 3, 3)}}
    placed = parallel.shard_params(params, mesh)["blk"]
    assert all(isinstance(t, DTensor) for t in placed.values())
    assert placed["attn.to_q.weight"].placements[-1] == Shard(0)
    assert placed["attn.to_out.0.weight"].placements[-1] == Shard(1)
    assert placed["attn.to_out.0.bias"].placements[-1] == Replicate()
    assert placed["conv1.weight"].placements[-1] == Replicate()  # 5 output channels
    # each rank keeps its own shard of its own copy; a dim of one rank
    # replicates, and a replicated tensor is the tree's own
    assert torch.equal(placed["attn.to_q.weight"].to_local(), torch.ones(4, 4))
    assert all(p == Replicate() for p in placed["attn.to_q.weight"].placements[:-1])
    bias = params["blk"]["attn.to_out.0.bias"]
    assert placed["attn.to_out.0.bias"].to_local().data_ptr() == bias.data_ptr()


def test_placement_refuses_tensors_off_the_mesh_device(world):
    """A CUDA model on a gloo mesh would be copied to the CPU: refused (here
    a meta tensor on the CPU mesh of the fake group)."""
    mesh = parallel.create_mesh(data=-1)
    off = torch.empty(2, 4, device="meta")
    with pytest.raises(ValueError, match="initialize_distributed"):
        parallel.shard_params({"w": off}, mesh)
    with pytest.raises(ValueError, match="initialize_distributed"):
        parallel.shard_for_sampling(mesh, {}, off)


def test_initialize_distributed_brings_up_nccl_on_the_card_unless_asked(monkeypatch):
    """Without `device`, the process group is NCCL on the card (so a host
    without CUDA refuses); gloo only for device="cpu"."""
    from perceptor_tpu_torch.parallel import mesh as pmesh

    calls = []
    monkeypatch.setattr(pmesh.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(pmesh.dist, "init_process_group",
                        lambda backend, **kwargs: calls.append((backend, kwargs)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            parallel.initialize_distributed("localhost:1234", 1, 0)
    parallel.initialize_distributed("localhost:1234", 2, 1, device="cpu", timeout=5)
    assert calls[-1] == ("gloo", {"init_method": "tcp://localhost:1234", "world_size": 2,
                                  "rank": 1, "timeout": 5})


def test_placed_params_are_kept_until_a_tensor_changes(world):
    """`sample(mesh=)` places a module's weights once per mesh and rules;
    an in-place update or a new tensor places them anew."""
    mesh = parallel.create_mesh(data=-1, tensor=2)
    layer = torch.nn.Linear(4, 8)
    first = partition.placed_params(layer, mesh)
    assert partition.placed_params(layer, mesh) is first
    assert partition.placed_params(layer, parallel.create_mesh(data=-1, context=2)) is not first
    with torch.no_grad():
        layer.weight.add_(1.0)
    second = partition.placed_params(layer, mesh)
    assert second is not first
    assert torch.equal(second["weight"].to_local(), layer.weight.detach())
    layer.bias = torch.nn.Parameter(torch.zeros(8))
    assert partition.placed_params(layer, mesh) is not second


# -- the routing report -------------------------------------------------------


def test_routing_report_of_a_tiny_unet_matches_jax_explain(world, models):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    jsd, sd = models
    jmesh, mesh = _meshes(context=2)
    rng = np.random.default_rng(3)
    latents = rng.standard_normal((1, 4, 16, 16)).astype(np.float32)
    cfg = jsd_config.TINY_TEXT
    context = rng.standard_normal((1, cfg.context_length, cfg.width)).astype(np.float32)
    ts = np.array([500.0], np.float32)
    want = jparallel.explain(
        lambda x, t, c: jsd.unet.apply({"params": jsd.params["unet"]}, x, t, c),
        jnp.asarray(latents), jnp.asarray(ts), jnp.asarray(context), mesh=jmesh)
    got = parallel.explain(sd.unet, torch.from_numpy(latents), torch.from_numpy(ts),
                           torch.from_numpy(context), mesh=mesh)
    # the attention records string for string; the entry's shard_spatial
    # record holds the port's NCHW shape where JAX's holds NHWC, and the
    # port reports what runs: a plain tensor's activations stay replicated
    # over the context axis (no halo exchange in DTensor), where GSPMD
    # shards them
    attention = [line for line in got.summary().splitlines() if line.startswith("attention")]
    assert attention == [line for line in want.summary().splitlines()
                         if line.startswith("attention")]
    assert len(attention) == 4
    (spatial,) = [r for r in got if r.site == "shard_spatial"]
    (j_spatial,) = [r for r in want if r.site == "shard_spatial"]
    n, c, h, w = spatial.shape
    assert (n, h, w, c) == j_spatial.shape and j_spatial.route == "sharded"
    assert spatial.route is None and "replicated over context axis 2" in spatial.reason
    j_routes = want.routes()
    j_routes[None] = j_routes.pop("sharded")
    assert got.routes() == j_routes and set(got.routes()) == {"ulysses", None}
    # a DTensor is pinned to the plan's placements and recorded as JAX does
    with parallel.context_parallel(mesh), parallel.record_routing() as pinned:
        x = distribute_tensor(torch.from_numpy(latents), mesh,
                              [Replicate()] * mesh.ndim)
        y = parallel.shard_spatial(x, h_axis=2)
    (rec,) = pinned.records
    assert rec.route == "sharded" and rec.reason.split(" (")[0] == j_spatial.reason.split(" (")[0]
    assert y.placements[mesh.mesh_dim_names.index("context")] == Shard(2)
    plain = parallel.explain(sd.unet, torch.from_numpy(latents), torch.from_numpy(ts),
                             torch.from_numpy(context))
    assert plain.routes() == {"xla": 8}  # no CUDA tensor on this host: the plain route


# -- the collective inventory --------------------------------------------------


def _jax_counts(fn, *args):
    return jhlo.collective_counts(jax.jit(fn).lower(*args).compile().as_text())


@pytest.mark.parametrize("n", [2, 4])
def test_collective_counts_of_traced_ring_and_ulysses_match_jax(world, n):
    jmesh, mesh = _meshes(context=n)
    group = (mesh, "context")
    q = torch.zeros(1, 4, 64 // n, 16)
    kv = torch.zeros(1, 4, 78 // n if 78 % n == 0 else 80 // n, 16)
    ring = make_fx(lambda a, b, c: parallel.ring_self_attention(a, b, c, group),
                   tracing_mode="fake")(q, q, q)
    ulysses = make_fx(lambda a, b, c: parallel.ulysses_self_attention(a, b, c, group, kv_len=77),
                      tracing_mode="fake")(q, kv, kv)
    jq, jk = jnp.zeros((1, 4, 64, 16)), jnp.zeros((1, 4, 77, 16))
    j_ring = _jax_counts(lambda a, b, c: jparallel.ring_attention(a, b, c, jmesh), jq, jq, jq)
    j_ulysses = _jax_counts(lambda a, b, c: jparallel.ulysses_attention(a, b, c, jmesh),
                            jq, jk, jk)
    assert hlo.collective_counts(ring) == j_ring == {"collective-permute": 2 * (n - 1)}
    assert hlo.collective_counts(ulysses) == j_ulysses == {"all-to-all": 4}
    text = ring.print_readable(print_output=False)
    assert hlo.collective_counts(text) == hlo.collective_counts(ring)
    assert hlo.max_gather_elements(ring) == hlo.max_gather_elements(ulysses) == 0
    permute = hlo.collective_inventory(ring)[0]
    # the shift moves the block flattened
    assert permute.elements == q.numel() and permute.dtypes == ("f32",)
    assert hlo.program_ici_bytes(ring)["total"] == 2 * (n - 1) * q.numel() * 4
    a2a = hlo.collective_inventory(ulysses)[0]
    assert a2a.group_size is None or a2a.group_size == n


def test_max_gather_elements_sees_the_gathered_weights_of_a_tensor_parallel_layer(world):
    """A column-parallel weight, gathered for the call by
    `partition.gathered_params`, is one all-gather of the weight's size."""
    from torch.distributed.tensor import DTensor

    mesh = parallel.create_mesh(data=-1, tensor=2)
    layer = torch.nn.Linear(8, 16)
    spec = partition.placements(partition.P("tensor"), mesh)

    def step(w_local, b, x):
        weight = DTensor.from_local(w_local, mesh, spec, run_check=False)
        sharded = {"net": {"weight": weight, "bias": b}}
        with partition.gathered_params({"net": layer}, sharded):
            return layer(x)

    gm = make_fx(step, tracing_mode="fake")(torch.zeros(8, 8), torch.zeros(16), torch.zeros(2, 8))
    assert hlo.collective_counts(gm) == {"all-gather": 1}
    assert hlo.max_gather_elements(gm) == 16 * 8
    inventory = hlo.collective_inventory(gm)
    assert inventory[0].group_size == 2
    assert hlo.program_ici_bytes(gm)["all-gather"] == 16 * 8 * 4 // 2


def test_collective_inventory_parses_the_jax_names_from_text():
    text = "\n".join([
        'all_gather_into_tensor: "bf16[4, 8]" = torch.ops._c10d_functional.'
        "all_gather_into_tensor.default(x, 2, '0')",
        'all_reduce: "f32[3]" = torch.ops._c10d_functional.all_reduce.default(y, \'sum\', \'0\')',
        'reduce_scatter_tensor: "f32[2]" = torch.ops._c10d_functional.'
        "reduce_scatter_tensor.default(z, 'sum', 4, '0')",
        'all_to_all_single: "f32[6]" = torch.ops._c10d_functional.'
        "all_to_all_single.default(w, [3, 3], [3, 3], '0')",
        'all_to_all_single_1: "f32[6]" = torch.ops._c10d_functional.'
        "all_to_all_single.default(v, [0, 6], [6, 0], '0')",
        'wait_tensor: "f32[6]" = torch.ops._c10d_functional.wait_tensor.default(v)',
    ])
    inventory = hlo.collective_inventory(text)
    assert [op.op for op in inventory] == ["all-gather", "all-reduce", "reduce-scatter",
                                           "all-to-all", "collective-permute"]
    assert inventory[0].output_bytes == 4 * 8 * 2 and inventory[0].group_size == 2
    assert hlo.max_gather_elements(text) == 32
    assert hlo.program_ici_bytes(text, default_group=2) == {
        "all-gather": 32, "all-reduce": 12, "reduce-scatter": 24, "collective-permute": 24,
        "all-to-all": 12, "total": 104}


# -- the profiler trace reader ------------------------------------------------


def test_hlo_trace_reads_a_profiler_trace_and_rolls_up_as_jax(tmp_path, capsys):
    """`load_ops` over `utils.profiling.trace`'s Chrome trace (a CPU run
    holds no device event, so its CPU ops are read), and `rollup` equal to
    JAX's on the same events."""
    import dataclasses

    from perceptor_tpu.utils import hlo_trace as jhlo_trace
    from perceptor_tpu_torch.utils import hlo_trace, profiling

    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("unet"):
            (x @ x).relu().sum()
    ops = hlo_trace.load_ops(str(tmp_path))
    assert ops and {op.category for op in ops} == {"cpu_op"}
    assert "aten::mm" in {op.name for op in ops}
    assert all(op.duration_ms >= 0 for op in ops)
    subsystems = {"matmul": "mm", "relu": "relu"}
    j_ops = [jhlo_trace.OpEvent(**dataclasses.asdict(op)) for op in ops]
    assert hlo_trace.rollup(ops, subsystems) == jhlo_trace.rollup(j_ops, subsystems)
    hlo_trace.print_rollup(ops, subsystems, top=3)
    assert "device total" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError):
        hlo_trace.load_ops(str(tmp_path / "none"))
