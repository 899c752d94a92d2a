"""The port's `utils/stats.py` against the JAX package's on the CPU: the same
numpy values through JAX's `stats.report` / `Collector` and the port's give
the same `num`, `mean` and `std` (JAX's own cases of tests/test_stats.py:
windows, keep_previous, the single-sample std, the regex filter, merge,
report0), and `all_reduce` sums a bag over a one-process gloo group.

JAX accumulates the moments in fp32, the port in float64 (from the same
fp32 values), and both difference them in float64 on the host, so the
collectors agree to fp32 rounding of the sums (1e-6 relative) where the
mean is not far above the std; where it is, the port's std still matches
numpy's float64 one.
"""

import numpy as np
import pytest
import torch

import test_torch_cpu_guard  # noqa: F401  (the first-call torch.exp guard)
from perceptor_tpu.utils import stats as jstats
from perceptor_tpu_torch.utils import stats


def _same(jc, tc, name):
    assert jc.num(name) == tc.num(name)
    for attr in ("mean", "std"):
        j, t = getattr(jc, attr)(name), getattr(tc, attr)(name)
        assert (np.isnan(j) and np.isnan(t)) or np.isclose(j, t, rtol=1e-6, atol=1e-7), (attr, j, t)


@pytest.mark.parametrize("shapes", [[(37,), (5, 4)], [(1,)], [(3, 3, 3), (2,), (11,)]])
def test_moments_mean_std_match_jax_and_numpy(shapes):
    rng = np.random.default_rng(len(shapes))
    values = [(rng.standard_normal(s) * 3 + 1).astype(np.float32) for s in shapes]
    jbag, tbag = jstats.zeros(["x"]), stats.zeros(["x"])
    for v in values:
        jbag = jstats.report(jbag, "x", v)
        tbag = stats.report(tbag, "x", torch.from_numpy(v))
    jc, tc = jstats.Collector(), stats.Collector()
    jc.update(jbag)
    tc.update(tbag)
    _same(jc, tc, "x")
    ref = np.concatenate([v.ravel() for v in values])
    assert tc.num("x") == ref.size
    assert np.isclose(tc.mean("x"), ref.mean(), atol=1e-5)
    assert np.isclose(tc.std("x"), ref.std(), atol=1e-4)
    assert tc["x"] == tc.mean("x")


def test_collector_windows_and_keep_previous_match_jax():
    both = [(jstats, jstats.zeros(["loss"]), jstats.Collector()),
            (stats, stats.zeros(["loss"]), stats.Collector())]
    script = [[2.0, 4.0], [10.0], []]
    for values in script:
        for i, (module, bag, collector) in enumerate(both):
            for v in values:
                bag = module.report(bag, "loss", v)
            collector.update(bag)
            both[i] = (module, bag, collector)
        _same(both[0][2], both[1][2], "loss")
    assert both[1][2].num("loss") == 1 and both[1][2].mean("loss") == 10.0

    jbag, tbag = both[0][1], both[1][1]
    jc, tc = jstats.Collector(keep_previous=False), stats.Collector(keep_previous=False)
    for _ in range(2):
        jc.update(jbag)
        tc.update(tbag)
        _same(jc, tc, "loss")
    assert np.isnan(tc.mean("loss"))


def test_std_edge_cases_regex_and_as_dict_match_jax():
    jbag = jstats.report(jstats.zeros(["a/one", "b/none"]), "a/one", 5.0)
    tbag = stats.report(stats.zeros(["a/one", "b/none"]), "a/one", 5.0)
    jc, tc = jstats.Collector(regex=r"a/.*"), stats.Collector(regex=r"a/.*")
    jc.update(jbag)
    tc.update(tbag)
    assert tc.std("a/one") == jc.std("a/one") == 0.0
    assert tc.names() == jc.names() == ["a/one"]
    assert tc.as_dict() == jc.as_dict()


def test_add_of_fresh_windows_matches_jax():
    rng = np.random.default_rng(3)
    jc, tc = jstats.Collector(), stats.Collector()
    for _ in range(3):
        v = rng.standard_normal(8).astype(np.float32)
        jc.add(jstats.report(jstats.zeros(["v"]), "v", v))
        tc.add(stats.report(stats.zeros(["v"]), "v", torch.from_numpy(v)))
        _same(jc, tc, "v")


def test_merge_and_report0_match_jax():
    ja = jstats.report(jstats.zeros(["x"]), "x", np.ones(3, np.float32))
    jb = jstats.report(jstats.zeros(["x", "y"]), "x", np.zeros(1, np.float32))
    ta = stats.report(stats.zeros(["x"]), "x", torch.ones(3))
    tb = stats.report(stats.zeros(["x", "y"]), "x", torch.zeros(1))
    jm, tm = jstats.merge(ja, jb), stats.merge(ta, tb)
    assert float(tm["x"].count) == float(jm["x"].count) == 4
    assert set(tm) == set(jm) == {"x", "y"}
    bag = stats.report0(stats.zeros([]), "z", 7.0)
    assert float(bag["z"].count) == float(jstats.report0(jstats.zeros([]), "z", 7.0)["z"].count)


def test_all_reduce_is_the_identity_without_a_group_and_sums_over_one(tmp_path):
    bag = stats.report(stats.zeros(["x"]), "x", torch.arange(4.0))
    assert stats.all_reduce(bag) is bag
    dist = torch.distributed
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        reduced = stats.all_reduce(bag)
        for field in ("count", "total", "total_sq"):
            assert torch.equal(getattr(reduced["x"], field), getattr(bag["x"], field))
        bag0 = stats.report0(stats.zeros([]), "z", 2.0)  # rank 0 reports
        assert float(bag0["z"].count) == 1
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mean_over_std,n", [(10.0, 3), (100.0, 64), (1e3, 1000)])
def test_std_keeps_its_digits_where_the_mean_dwarfs_it(mean_over_std, n):
    """A statistic whose mean is far above its std (a loss near 1.25 that
    moves by 0.13): the port's std matches numpy's float64 one to 1e-6,
    one value reported at a time as a training loop does."""
    rng = np.random.default_rng(int(mean_over_std))
    values = (mean_over_std + rng.standard_normal(n)).astype(np.float32) * np.float32(0.13)
    bag = stats.zeros(["loss"])
    for v in values:
        bag = stats.report(bag, "loss", torch.tensor(v))
    collector = stats.Collector()
    collector.update(stats.all_reduce(bag))
    want = values.astype(np.float64)
    assert collector.num("loss") == n
    assert np.isclose(collector.mean("loss"), want.mean(), rtol=1e-6)
    assert np.isclose(collector.std("loss"), want.std(), rtol=1e-6, atol=1e-7)
