"""The port's exact URNG oracles, baselines and bench tables against the
reference, on the CPU.

* ``build_exact`` (unified and classical, with a node mask),
  ``DenseGraph.projection``/``induced`` and ``greedy_monotonic_path`` are
  bitwise on integer-valued vectors, where every distance is exact.
* ``PostFilterIndex``, ``HiPNGLite`` and ``build_rrng``: searches over
  graphs the reference built agree in ids, distances and step counts bit
  for bit on integer data, and the port builds the same graphs there.
* On the Gaussian fixture of ``tests/test_baselines_and_hlo.py`` the
  port-built baselines' recall is within 0.02 of the reference's own.
* The port's bench tables emit the reference's row names.

The reference's share of the time is its jit compiles (one per shape, so
the small cases use few shapes); the Gaussian builds use one refinement
round in both packages for the same reason.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import UGConfig as RefConfig
from repro.core import baselines as rb
from repro.core import exact as rex
from repro.core import intervals as riv
from repro.core import recall as ref_recall
from repro.core.search import brute_force as ref_brute_force
from repro.core.search import beam_search as ref_beam_search
from repro.core.store import make_store as ref_make_store
from repro_torch.core import Semantics, UGConfig, beam_search, make_store
from repro_torch.core import baselines as pb
from repro_torch.core import exact as pex
from repro_torch.core.exact import DenseGraph
from repro_torch.core.index import recall
from repro_torch.core.search import SearchResult

SMALL_CFG = dict(ef_spatial=16, ef_attribute=32, max_edges_if=16, max_edges_is=16,
                 iterations=2, repair_width=8, exact_spatial=True, block=128)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op torch thread: the suite runs its files in parallel
    processes, and a full thread pool in each oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_same_result(got, want):
    for g, w in ((got.ids, want.ids), (got.dist, want.dist), (got.steps, want.steps)):
        assert np.array_equal(bits(g), bits(w))


def assert_same_graph(got, want):
    assert np.array_equal(got.nbrs.numpy(), np.asarray(want.nbrs))
    assert np.array_equal(got.status.numpy(), np.asarray(want.status))


def int_queries(rng, nq, d, half=0.3):
    qv = rng.integers(-4, 5, (nq, d)).astype(np.float32)
    c = rng.uniform(size=(nq, 1))
    qi = np.concatenate([np.maximum(c - half, 0), np.minimum(c + half, 1)], axis=1)
    return qv, qi.astype(np.float32)


@pytest.fixture(scope="module")
def exact_case():
    """Integer-valued n = 220, d = 8 corpus with grid intervals, and the
    reference's exact URNG over it."""
    rng = np.random.default_rng(0)
    n, d = 220, 8
    x = rng.integers(-4, 5, (n, d)).astype(np.float32)
    ints = np.sort(rng.choice(np.linspace(0.0, 1.0, 9), size=(n, 2)), axis=1).astype(np.float32)
    ref = rex.build_exact(jnp.asarray(x), jnp.asarray(ints), unified=True)
    port = pex.build_exact(x, ints, unified=True, device="cpu")
    return x, ints, ref, port, rng


# ------------------------------------------------------------------ exact URNG
def test_build_exact_unified_bitwise(exact_case):
    _, _, ref, port, _ = exact_case
    assert_same_graph(port, ref)
    assert port.nbrs.dtype == torch.int32 and port.status.dtype == torch.uint8


def test_build_exact_classical_rng_bitwise(exact_case):
    x, ints, _, _, _ = exact_case
    ref = rex.build_exact(jnp.asarray(x), jnp.asarray(ints), unified=False)
    assert_same_graph(pex.build_exact(x, ints, unified=False, device="cpu"), ref)


@pytest.mark.parametrize("sem", [Semantics.IF, Semantics.IS])
def test_build_exact_node_mask_and_heredity(exact_case, sem):
    """Building on a query's valid set equals the reference's build and
    equals the full graph induced onto it (Thm 3.5)."""
    x, ints, ref_full, port_full, _ = exact_case
    window = torch.tensor([0.25, 0.75])
    mask = pex.iv.query_valid_mask(sem, torch.as_tensor(ints), window).numpy()
    ref = rex.build_exact(jnp.asarray(x), jnp.asarray(ints), unified=True, node_mask=mask)
    port = pex.build_exact(x, ints, unified=True, node_mask=mask, device="cpu")
    assert_same_graph(port, ref)
    induced = port_full.induced(mask)
    assert_same_graph(induced, ref_full.induced(jnp.asarray(mask)))

    def edges(g):
        nb, st = g.nbrs.numpy(), g.status.numpy()
        return {(u, int(v)) for u in range(nb.shape[0]) for v, s in zip(nb[u], st[u])
                if v >= 0 and s & sem.flag}
    assert edges(induced) == edges(port)


@pytest.mark.parametrize("sem", [Semantics.IF, Semantics.IS])
def test_projection_bitwise(exact_case, sem):
    _, _, ref, port, _ = exact_case
    assert_same_graph(port.projection(sem), ref.projection(riv.Semantics(sem.value)))


@pytest.mark.parametrize("sem", [Semantics.IF, Semantics.IS])
def test_greedy_monotonic_path_bitwise(exact_case, sem):
    x, _, ref, port, _ = exact_case
    rng = np.random.default_rng(1)
    reached = 0
    for s, t in rng.integers(0, x.shape[0], (20, 2)).tolist():
        want = rex.greedy_monotonic_path(ref, jnp.asarray(x), riv.Semantics(sem.value), s, t)
        got = pex.greedy_monotonic_path(port, torch.as_tensor(x), sem, s, t)
        assert got == want
        reached += got[-1] == t
    assert reached > 0


# ------------------------------------------------- baselines on handed graphs
@pytest.mark.parametrize("sem", [Semantics.IF, Semantics.IS])
def test_postfilter_search_on_reference_graph_bitwise(exact_case, sem):
    """The reference's classical RNG as the interval-agnostic graph."""
    x, ints, _, _, _ = exact_case
    g = rex.build_exact(jnp.asarray(x), jnp.asarray(ints), unified=False)
    ref = rb.PostFilterIndex(jnp.asarray(x), jnp.asarray(ints), g)
    port = pb.PostFilterIndex(torch.as_tensor(x), torch.as_tensor(ints),
                              DenseGraph(torch.as_tensor(np.asarray(g.nbrs)),
                                         torch.as_tensor(np.asarray(g.status))))
    qv, qi = int_queries(np.random.default_rng(2), 24, x.shape[1])
    want = ref.search(jnp.asarray(qv), jnp.asarray(qi), sem=riv.Semantics(sem.value),
                      ef=32, k=10, oversample=8)
    assert_same_result(port.search(qv, qi, sem=sem, ef=32, k=10, oversample=8), want)


@pytest.fixture(scope="module")
def build_case():
    """Integer n = 300, d = 8 corpus for the graph builds."""
    rng = np.random.default_rng(3)
    n, d = 300, 8
    x = rng.integers(-4, 5, (n, d)).astype(np.float32)
    ints = np.sort(rng.uniform(size=(n, 2)), axis=1).astype(np.float32)
    return x, ints, rng


def test_postfilter_build_and_prefilter_bitwise(build_case):
    x, ints, rng = build_case
    d = x.shape[1]
    ref = rb.PostFilterIndex.build(jnp.asarray(x), jnp.asarray(ints), RefConfig(**SMALL_CFG))
    port = pb.PostFilterIndex.build(x, ints, UGConfig(**SMALL_CFG), device="cpu")
    assert_same_graph(port.graph, ref.graph)
    qv, qi = int_queries(rng, 16, d)
    for sem in (Semantics.IF, Semantics.IS):
        want = rb.prefilter_search(jnp.asarray(x), jnp.asarray(ints), qv, qi,
                                   sem=riv.Semantics(sem.value), k=10)
        got = pb.prefilter_search(torch.as_tensor(x), torch.as_tensor(ints), qv, qi, sem=sem, k=10)
        assert np.array_equal(got.ids.numpy(), np.asarray(want.ids))
        assert np.array_equal(bits(got.dist), bits(want.dist))


@pytest.fixture(scope="module")
def hipng_case():
    """Integer vectors whose intervals put 8 objects in each node of a
    depth-1 tree: complete graphs of one shape (the port-built graphs of
    larger partitions are held by recall below and by the bench test)."""
    rng = np.random.default_rng(4)
    spans = [(0.3, 0.7)] * 8 + [(0.0, 0.5)] * 8 + [(0.5, 1.0)] * 8
    lo = np.array([a for a, _ in spans])
    hi = np.array([b for _, b in spans])
    w = (hi - lo)[:, None] * rng.uniform(0.0, 0.45, (len(spans), 2))
    ints = np.stack([lo + w[:, 0], hi - w[:, 1]], axis=1).astype(np.float32)
    x = rng.integers(-4, 5, (len(spans), 8)).astype(np.float32)
    ref = rb.HiPNGLite.build(jnp.asarray(x), jnp.asarray(ints), depth=1,
                             config=RefConfig(**SMALL_CFG))
    return x, ints, ref


def test_hipng_build_matches_reference(hipng_case):
    x, ints, ref = hipng_case
    port = pb.HiPNGLite.build(x, ints, depth=1, config=UGConfig(**SMALL_CFG), device="cpu")
    assert len(port.partitions) == len(ref.partitions) == 3
    for p, r in zip(port.partitions, ref.partitions):
        assert (p.lo, p.hi) == (r.lo, r.hi)
        assert np.array_equal(p.node_ids.numpy(), r.node_ids)
        assert (p.graph is None) == (r.graph is None)
        if p.graph is not None:
            assert_same_graph(p.graph, r.graph)


def test_hipng_search_on_reference_graphs_bitwise(hipng_case):
    x, ints, ref = hipng_case
    parts = [(r.lo, r.hi, r.node_ids, None if r.graph is None else np.asarray(r.graph.nbrs),
              None if r.graph is None else np.asarray(r.graph.status)) for r in ref.partitions]
    port = pb.HiPNGLite.from_arrays(x, ints, parts, depth=1, device="cpu")
    qv, qi = int_queries(np.random.default_rng(5), 20, 8, half=0.2)
    want = ref.search(jnp.asarray(qv), jnp.asarray(qi), ef=16, k=5)
    assert_same_result(port.search(qv, qi, ef=16, k=5), want)


def numpy_graph(key, xs, ivs, cfg):
    """Stands in for the reference's ``build_ug`` inside ``HiPNGLite.build``:
    a seeded random graph over the partition's rows, with a padding column,
    so the reference assigns and searches at depth 2 without compiling a
    build per partition."""
    m = xs.shape[0]
    rng = np.random.default_rng(m)
    nbrs = np.stack([rng.permutation(m)[:6] for _ in range(m)]).astype(np.int32)
    nbrs = np.concatenate([nbrs, np.full((m, 1), -1, np.int32)], axis=1)
    return rex.DenseGraph(jnp.asarray(nbrs), jnp.full(nbrs.shape, riv.FLAG_BOTH, jnp.uint8))


@pytest.fixture(scope="module")
def hipng_depth2_case():
    """Integer n = 200, d = 8 corpus with endpoints on the eighths, so many
    intervals end exactly on a range boundary; the reference's depth-2
    Hi-PNG over it, its graphs from :func:`numpy_graph`."""
    rng = np.random.default_rng(7)
    n, d = 200, 8
    x = rng.integers(-4, 5, (n, d)).astype(np.float32)
    ints = np.sort(rng.choice(np.linspace(0.0, 1.0, 9), size=(n, 2)), axis=1).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rb, "build_ug", numpy_graph)
        ref = rb.HiPNGLite.build(jnp.asarray(x), jnp.asarray(ints), depth=2,
                                 config=RefConfig(**SMALL_CFG))
    return x, ints, ref


def test_hipng_depth2_assignment_matches_reference(hipng_depth2_case):
    """Seven ranges, and each object at the deepest one that holds it."""
    x, ints, ref = hipng_depth2_case
    ranges = pb.segment_ranges(2)
    assert [(lo, hi) for lo, hi, _ in ranges] == [(r.lo, r.hi) for r in ref.partitions]
    assign = pb.assign_partitions(torch.as_tensor(ints), ranges)
    for pid, r in enumerate(ref.partitions):
        assert np.array_equal(torch.nonzero(assign == pid).flatten().numpy(), r.node_ids)
    sizes = [r.node_ids.size for r in ref.partitions]
    assert len(sizes) == 7 and min(sizes) > 8 and sum(sizes) == x.shape[0]


def test_hipng_depth2_search_on_reference_graphs_bitwise(hipng_depth2_case):
    x, ints, ref = hipng_depth2_case
    parts = [(r.lo, r.hi, r.node_ids, np.array(r.graph.nbrs), np.array(r.graph.status))
             for r in ref.partitions]
    port = pb.HiPNGLite.from_arrays(x, ints, parts, depth=2, device="cpu")
    qv, qi = int_queries(np.random.default_rng(8), 20, 8, half=0.3)
    want = ref.search(jnp.asarray(qv), jnp.asarray(qi), ef=16, k=5)
    got = port.search(qv, qi, ef=16, k=5)
    assert_same_result(got, want)
    assert (got.ids.numpy() >= 0).any()


def test_rrng_build_and_search_bitwise(build_case):
    x, ints, _ = build_case
    scalars = ints[:, 0]
    cfg = SMALL_CFG
    ref_g = rb.build_rrng(jax.random.key(0), jnp.asarray(x), jnp.asarray(scalars), RefConfig(**cfg))
    port_g = pb.build_rrng(torch.Generator().manual_seed(0), torch.as_tensor(x),
                           torch.as_tensor(scalars), UGConfig(**cfg))
    assert_same_graph(port_g, ref_g)
    # an RF search over the reference's graph, entered at the nodes nearest
    # each window's centre in scalar order (no entry structure to build)
    points = np.stack([scalars, scalars], axis=1)
    qv, qi = int_queries(np.random.default_rng(6), 16, x.shape[1])
    entry = np.abs(scalars[None, :] - qi.mean(axis=1)[:, None]).argmin(axis=1).astype(np.int32)
    store_r = ref_make_store(jnp.asarray(x), jnp.asarray(points), ref_g.nbrs, ref_g.status,
                             build_entry=False)
    store_p = make_store(x, points, np.asarray(ref_g.nbrs), np.asarray(ref_g.status),
                         build_entry=False, device="cpu")
    want = ref_beam_search(store_r, jnp.asarray(entry), jnp.asarray(qv), jnp.asarray(qi),
                           sem=riv.Semantics.RF, ef=32, k=10, backend="xla")
    got = beam_search(store_p, torch.as_tensor(entry), torch.as_tensor(qv), torch.as_tensor(qi),
                      sem=Semantics.RF, ef=32, k=10)
    assert_same_result(got, want)
    assert (got.ids.numpy() >= 0).any()


# ------------------------------------------------------- recall on Gaussians
@pytest.fixture(scope="module")
def gauss():
    """The data of tests/test_baselines_and_hlo.py, handed to both packages."""
    k1, k2, k3, k4 = jax.random.split(jax.random.key(21), 4)
    n, d, nq = 1200, 12, 24
    x = np.asarray(jax.random.normal(k1, (n, d)))
    ints = np.asarray(riv.sample_uniform_intervals(k2, n))
    qv = np.asarray(jax.random.normal(k3, (nq, d)))
    c = np.asarray(jax.random.uniform(k4, (nq, 1)))
    qi = np.concatenate([np.maximum(c - 0.3, 0), np.minimum(c + 0.3, 1)], axis=1)
    # that file's build config with one refinement round: the second round's
    # wider pool would cost the reference another compile per partition
    cfg = dict(ef_spatial=24, ef_attribute=48, max_edges_if=24, max_edges_is=24,
               iterations=1, repair_width=8, exact_spatial=True, block=768)
    truth = ref_brute_force(jnp.asarray(x), jnp.asarray(ints), jnp.asarray(qv),
                            jnp.asarray(qi), sem=riv.Semantics.IF, k=10)
    truth = SearchResult(torch.as_tensor(np.asarray(truth.ids)), None, None)
    return x, ints, qv, qi.astype(np.float32), cfg, truth


def test_postfilter_recall_matches_reference(gauss):
    x, ints, qv, qi, cfg, truth = gauss
    ref = rb.PostFilterIndex.build(jnp.asarray(x), jnp.asarray(ints), RefConfig(**cfg))
    port = pb.PostFilterIndex.build(x, ints, UGConfig(**cfg), device="cpu")
    want = ref_recall(ref.search(jnp.asarray(qv), jnp.asarray(qi), sem=riv.Semantics.IF,
                                 ef=128, k=10, oversample=8), truth)
    res = port.search(qv, qi, sem=Semantics.IF, ef=128, k=10, oversample=8)
    got = recall(res, truth)
    assert abs(got - want) <= 0.02
    ids = res.ids.numpy()
    ok = (ints[ids][..., 0] >= qi[:, None, 0]) & (ints[ids][..., 1] <= qi[:, None, 1])
    assert ok[ids >= 0].all()


def test_hipng_recall_matches_reference(gauss):
    """depth = 1 (three partitions) keeps the reference's CPU build short."""
    x, ints, qv, qi, cfg, truth = gauss
    ref = rb.HiPNGLite.build(jnp.asarray(x), jnp.asarray(ints), depth=1, config=RefConfig(**cfg))
    port = pb.HiPNGLite.build(x, ints, depth=1, config=UGConfig(**cfg), device="cpu")
    want = ref_recall(ref.search(jnp.asarray(qv), jnp.asarray(qi), ef=96, k=10), truth)
    got = recall(port.search(qv, qi, ef=96, k=10), truth)
    assert abs(got - want) <= 0.02


def test_prefilter_recall_is_one(gauss):
    x, ints, qv, qi, _, truth = gauss
    res = pb.prefilter_search(torch.as_tensor(x), torch.as_tensor(ints), qv, qi,
                              sem=Semantics.IF, k=10)
    assert recall(res, truth) == 1.0


# ---------------------------------------------------------------- bench tables
REF_ROWS = {
    "ifann": ["ifann_ug_ef16", "ifann_ug_ef32", "ifann_ug_ef64", "ifann_ug_ef128",
              "ifann_postfilter_ef32", "ifann_postfilter_ef128", "ifann_hipng_ef64",
              "ifann_prefilter_exact"],
    "query_types": ["qtype_if", "qtype_is", "qtype_rs", "qtype_rf"],
    "workloads": ["workload_short", "workload_long", "workload_mixed", "workload_uniform"],
    "indexing": ["index_build_ug", "index_build_postfilter", "index_build_hipng",
                 "index_degrees_ug"],
    "vary_k": ["vary_k_1", "vary_k_10", "vary_k_20", "vary_k_50"],
}


def test_bench_tables_emit_reference_rows(monkeypatch):
    """Every table at n = 600 on the CPU carries the reference's row names
    (a small build config keeps the three builds short; the names do not
    depend on it), and the pre-filter is exact."""
    from repro_torch.bench import common, tables

    monkeypatch.setattr(common, "TIMED_CALLS", (0, 1))   # the rows matter here, not the times
    b = common.Bench(n=600, nq=8, device="cpu", cfg=UGConfig(**dict(SMALL_CFG, iterations=1)))
    got = {"ifann": tables.bench_ifann(b), "query_types": tables.bench_query_types(b),
           "workloads": tables.bench_workloads(b), "indexing": tables.bench_indexing(b),
           "vary_k": tables.bench_k(b)}
    for name, rows in got.items():
        assert [r["name"] for r in rows] == REF_ROWS[name]
    by = {r["name"]: r["metrics"] for rows in got.values() for r in rows}
    assert by["ifann_prefilter_exact"]["recall"] == 1.0
    assert by["index_build_hipng"]["partitions"] == 7
    assert all(r["us_per_call"] >= 0 for rows in got.values() for r in rows)


def test_bench_entry_point_kernel_table(tmp_path, monkeypatch):
    """``python -m repro_torch.bench.run`` on the CPU: the device is named
    and the kernel table has its plain rows (its CUDA rows need the card)."""
    import json

    from repro_torch.bench import common, run

    out = tmp_path / "rows.json"
    monkeypatch.setattr(common, "TIMED_CALLS", (0, 1))
    assert run.main(["--only", "kernels", "--device", "cpu", "--json", str(out)]) == 0
    blob = json.loads(out.read_text())
    assert blob["device"]["platform"] == "cpu"
    assert [r["name"] for r in blob["rows"]] == [
        "kernel_l2dist_torch_plain", "kernel_fusedscan_torch_plain",
        "kernel_expandscore_torch_plain", "kernel_expandscore_legacy"]
    assert blob["rows"][0]["metrics"] == {"seconds": blob["rows"][0]["metrics"]["seconds"],
                                          "nq": 64, "nx": 4096, "d": 128}
    assert common.Bench(n=600, device="cpu").config == common.UG_CFG
    assert not common.Bench(n=10_000, device="cpu").config.exact_spatial
