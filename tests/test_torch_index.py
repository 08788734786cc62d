"""Whole builds and searches of the port against the reference, on the CPU.

* An ``exact_spatial`` build (no randomness) on integer-valued vectors gives
  the reference's ``nbrs``/``status`` bit for bit.
* The port loads an index the reference saved and answers mixed IF/IS/RF/RS
  batches with the reference's ids, distances, step counts and iteration
  counts, bit for bit, for frontier widths 1 and 4; the reference loads
  what the port saved.
* ``meta.json``'s ``prune_backend`` crosses in both directions: a
  port-saved index takes the reference's ``insert``, and the reference's
  ``pallas``/``xla``/``legacy`` load as the port's ``cuda``/``torch``/``legacy``.
* Builds through NN-descent draw different random numbers in the two
  packages, so on Gaussian data they are held by recall@10 per semantics.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Semantics as RefSem
from repro.core import UGConfig as RefConfig
from repro.core import UGIndex as RefIndex
from repro.core import recall as ref_recall
from repro_torch.core import Semantics, UGConfig, UGIndex, make_store
from repro_torch.core.index import recall
from repro_torch.data import CorpusConfig, make_corpus

CYCLE = [Semantics.IF, Semantics.IS, Semantics.RS, Semantics.RF]
EXACT_CFG = dict(ef_spatial=12, ef_attribute=24, max_edges_if=10, max_edges_is=10,
                 iterations=2, repair_width=8, exact_spatial=True, block=128)


def mixed_queries(rng, nq, d, *, integer, half_if=0.3, half_is=0.3):
    """A shuffled batch cycling IF/IS/RS/RF: IF and RF windows of half-width
    ``half_if``, IS windows of ``half_is``, RS point windows."""
    qv = (rng.integers(-4, 5, (nq, d)) if integer else rng.normal(size=(nq, d))).astype(np.float32)
    c = rng.uniform(size=(nq, 1)).astype(np.float32)
    window = lambda h: np.concatenate([np.maximum(c - h, 0), np.minimum(c + h, 1)], axis=1)
    sems = [CYCLE[i % 4] for i in rng.permutation(nq)]
    half = {Semantics.IF: half_if, Semantics.RF: half_if, Semantics.IS: half_is, Semantics.RS: 0.0}
    qi = np.stack([window(half[s])[i] for i, s in enumerate(sems)])
    return qv, qi.astype(np.float32), sems


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The shapes here are small: torch's intra-op pool only contends with
    the other test processes and the reference's XLA threads, so this
    module runs torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def exact_case(tmp_path_factory):
    """A reference build on integer-valued vectors, saved to disk."""
    rng = np.random.default_rng(0)
    n, d = 300, 8
    x = rng.integers(-4, 5, (n, d)).astype(np.float32)
    ints = np.sort(rng.uniform(size=(n, 2)), axis=-1).astype(np.float32)
    ref = RefIndex.build(jnp.asarray(x), jnp.asarray(ints), RefConfig(**EXACT_CFG))
    path = tmp_path_factory.mktemp("ref_index")
    ref.save(path)
    qv, qi, sems = mixed_queries(rng, 32, d, integer=True)
    return x, ints, ref, path, (qv, qi, sems)


def test_exact_build_bitwise(exact_case):
    x, ints, ref, _, _ = exact_case
    port = UGIndex.build(x, ints, UGConfig(**EXACT_CFG), device="cpu")
    assert np.array_equal(port.graph.nbrs.numpy(), np.asarray(ref.graph.nbrs))
    assert np.array_equal(port.graph.status.numpy(), np.asarray(ref.graph.status))
    assert port.graph.status.dtype == torch.uint8 and port.graph.nbrs.dtype == torch.int32


@pytest.mark.parametrize("width", [1, 4])
def test_search_on_reference_saved_index_bitwise(exact_case, width):
    _, _, ref, path, (qv, qi, sems) = exact_case
    port = UGIndex.load(path, device="cpu")
    want = ref.search_mixed(jnp.asarray(qv), jnp.asarray(qi),
                            [RefSem(s.value) for s in sems], ef=32, k=10,
                            backend="xla", width=width)
    got = port.search_mixed(qv, qi, sems, ef=32, k=10, width=width)
    assert np.array_equal(got.ids.numpy(), np.asarray(want.ids))
    assert np.array_equal(got.dist.numpy().view(np.int32), np.asarray(want.dist).view(np.int32))
    assert np.array_equal(got.steps.numpy(), np.asarray(want.steps))
    assert got.iters == int(want.iters)


def test_mixed_equals_per_semantics(exact_case):
    _, _, _, path, (qv, qi, sems) = exact_case
    port = UGIndex.load(path, device="cpu")
    res = port.search_mixed(qv, qi, sems, ef=32, k=10, width=4)
    for s in CYCLE:
        sel = np.asarray([i for i, ss in enumerate(sems) if ss is s])
        one = port.search(qv[sel], qi[sel], sem=s, ef=32, k=10, width=4)
        assert np.array_equal(res.ids.numpy()[sel], one.ids.numpy())
        assert np.array_equal(res.dist.numpy()[sel].view(np.int32), one.dist.numpy().view(np.int32))
        assert np.array_equal(res.steps.numpy()[sel], one.steps.numpy())


def test_reference_loads_port_saved_index(exact_case, tmp_path):
    x, ints, _, _, (qv, qi, sems) = exact_case
    port = UGIndex.build(x, ints, UGConfig(**EXACT_CFG), device="cpu")
    port.save(tmp_path)
    ref = RefIndex.load(tmp_path)
    assert np.array_equal(np.asarray(ref.graph.nbrs), port.graph.nbrs.numpy())
    assert np.array_equal(np.asarray(ref.graph.status), port.graph.status.numpy())
    assert np.asarray(ref.intervals).dtype == np.float32
    want = ref.search_mixed(jnp.asarray(qv), jnp.asarray(qi),
                            [RefSem(s.value) for s in sems], ef=32, k=10, backend="xla")
    got = port.search_mixed(qv, qi, sems, ef=32, k=10)
    assert np.array_equal(got.ids.numpy(), np.asarray(want.ids))


def test_recall_within_reference_on_gaussian_data():
    """NN-descent builds in both packages, n = 1000, d = 16: recall@10 per
    semantics of the port's index is within 0.02 of the reference's.

    128 queries per semantics (about 1,280 truth items each; IS windows are
    narrow so that most IS queries have ten true neighbors).  The graphs
    have degree 32: a degree-16 graph's recall at this size swings from
    seed to seed by more than the bar in either package."""
    rng = np.random.default_rng(1)
    n, d = 1000, 16
    x = rng.normal(size=(n, d)).astype(np.float32)
    ints = np.sort(rng.uniform(size=(n, 2)), axis=-1).astype(np.float32)
    cfg = dict(ef_spatial=32, ef_attribute=32, max_edges_if=32, max_edges_is=32,
               iterations=2, repair_width=8, block=512)
    ref = RefIndex.build(jnp.asarray(x), jnp.asarray(ints), RefConfig(**cfg))
    port = UGIndex.build(x, ints, UGConfig(**cfg), device="cpu")
    qv, qi, sems = mixed_queries(rng, 512, d, integer=False, half_if=0.2, half_is=0.05)
    ref_sems = [RefSem(s.value) for s in sems]
    r_res = ref.search_mixed(jnp.asarray(qv), jnp.asarray(qi), ref_sems, ef=64, k=10,
                             backend="xla")
    p_res = port.search_mixed(qv, qi, sems, ef=64, k=10)
    for s in CYCLE:
        sel = np.asarray([i for i, ss in enumerate(sems) if ss is s])
        truth = ref.ground_truth(jnp.asarray(qv[sel]), jnp.asarray(qi[sel]), sem=RefSem(s.value), k=10)
        r = ref_recall(type(r_res)(r_res.ids[sel], r_res.dist[sel], r_res.steps[sel]), truth)
        p_truth = port.ground_truth(qv[sel], qi[sel], sem=s, k=10)
        assert np.array_equal(p_truth.ids.numpy(), np.asarray(truth.ids)), s
        p = recall(type(p_res)(p_res.ids[sel], p_res.dist[sel], p_res.steps[sel]), p_truth)
        assert abs(p - r) <= 0.02, (s, p, r)


def test_entry_points_need_a_card_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    x = np.zeros((4, 2), np.float32)
    ints = np.tile(np.asarray([[0.0, 1.0]], np.float32), (4, 1))
    nbrs = np.full((4, 2), -1, np.int32)
    status = np.zeros((4, 2), np.uint8)
    with pytest.raises(RuntimeError):
        UGIndex.build(x, ints)
    with pytest.raises(RuntimeError):
        make_store(x, ints, nbrs, status)
    with pytest.raises(RuntimeError):
        make_corpus(CorpusConfig(n=8, dim=2))
    UGIndex(make_store(x, ints, nbrs, status, device="cpu"), UGConfig()).save(tmp_path)
    with pytest.raises(RuntimeError):
        UGIndex.load(tmp_path)


# ------------------------------------------------- prune_backend in meta.json
@pytest.fixture(scope="module")
def bridge_case():
    """A small exact build (n = 200) shared by the backend-name tests."""
    rng = np.random.default_rng(5)
    n, d = 200, 8
    x = rng.integers(-4, 5, (n, d)).astype(np.float32)
    ints = np.sort(rng.uniform(size=(n, 2)), axis=-1).astype(np.float32)
    new_x = rng.integers(-4, 5, (3, d)).astype(np.float32)
    new_iv = np.sort(rng.uniform(size=(3, 2)), axis=-1).astype(np.float32)
    port = UGIndex.build(x, ints, UGConfig(**EXACT_CFG), device="cpu")
    return port, (new_x, new_iv)


def with_backend(index, name):
    return dataclasses.replace(index, config=dataclasses.replace(index.config,
                                                                 prune_backend=name))


def saved_backend(path) -> str | None:
    return json.loads((path / "meta.json").read_text())["prune_backend"]


@pytest.mark.parametrize("port_name,ref_name", [("torch", "xla"), ("cuda", "pallas"),
                                                (None, None)])
def test_port_saved_index_takes_reference_insert(bridge_case, tmp_path, port_name, ref_name):
    """The port writes the reference's name for the same role, so the
    reference's insert, which reuses the saved name, runs on it; the port
    reads its own name back."""
    port, (new_x, new_iv) = bridge_case
    with_backend(port, port_name).save(tmp_path)
    assert saved_backend(tmp_path) == ref_name
    ref = RefIndex.load(tmp_path)
    assert ref.config.prune_backend == ref_name
    grown = ref.insert(jnp.asarray(new_x), jnp.asarray(new_iv))
    assert int(grown.store.live_count()) == port.n + len(new_x)
    assert UGIndex.load(tmp_path, device="cpu").config.prune_backend == port_name


@pytest.mark.parametrize("ref_name,port_name", [("pallas", "cuda"), ("xla", "torch"),
                                                ("legacy", "legacy"), (None, None)])
def test_reference_saved_backend_loads_in_port(exact_case, tmp_path, ref_name, port_name):
    ref = exact_case[2]
    with_backend(ref, ref_name).save(tmp_path)
    assert saved_backend(tmp_path) == ref_name
    loaded = UGIndex.load(tmp_path, device="cpu")
    assert loaded.config.prune_backend == port_name
    assert np.array_equal(loaded.graph.nbrs.numpy(), np.asarray(ref.graph.nbrs))


@pytest.mark.parametrize("name,ok", [("torch", True), ("cuda", True), ("triton", False),
                                     ("", False)])
def test_port_names_in_meta_still_load(bridge_case, tmp_path, name, ok):
    """meta.json as earlier port releases wrote it (the port's own names)
    still loads; a name neither package knows raises."""
    port = bridge_case[0]
    port.save(tmp_path)
    meta = json.loads((tmp_path / "meta.json").read_text())
    meta["prune_backend"] = name
    (tmp_path / "meta.json").write_text(json.dumps(meta))
    if ok:
        assert UGIndex.load(tmp_path, device="cpu").config.prune_backend == name
    else:
        with pytest.raises(ValueError, match="prune_backend"):
            UGIndex.load(tmp_path, device="cpu")
