"""The port's serve runtime, on the CPU: the reference's runtime contracts
(``tests/test_serve_runtime.py``), each held against the port's own direct
``search_mixed``, and the pure-Python pieces against the reference's.

* **exactness**: however the coalescer slices the request stream, every
  reply equals a direct padded ``search_mixed`` on the reply's pinned
  snapshot, bit for bit (each row of a batch is independent of the rest);
* **snapshot consistency**: a query admitted before a write answers the
  pre-write snapshot, one admitted after the post-write one, and no write
  touches a tensor of the snapshot it replaced;
* **failed writes**: a write that raises answers its future with the
  error and leaves the index as it was, and the next write applies to
  that index;
* **deadlines**: expired requests are answered with ``DeadlineExceeded``
  (at admission or at dequeue), never dropped, and counted as rejected;
* **backpressure**: admission past ``max_queue`` raises ``QueueFull``;
* **single-read upserts**: ``ServeEngine.upsert`` reads ``index.n`` once a
  call, and every chunk lands on a ``BATCH_BUCKETS`` shape;
* ``bucket_batch_size``, ``upsert_chunk_plan``, ``LatencyReservoir`` and
  ``_pctl`` equal the reference's.
"""
import numpy as np
import pytest
import torch

import repro.serve.engine as ref_engine
import repro.serve.runtime as ref_runtime
from repro_torch.core import FLAG_IF, FLAG_IS, UGConfig, UGIndex
from repro_torch.core.search import search_mixed
from repro_torch.kernels.util import pad_rows
from repro_torch.serve import (
    DeadlineExceeded, QueueFull, RuntimeConfig, ServeEngine, ServeRuntime,
)
from repro_torch.serve.engine import (
    BATCH_BUCKETS, bucket_batch_size, pad_batch, upsert_chunk_plan,
)
from repro_torch.serve.runtime import LatencyReservoir, _pctl, count_pinned_matches

CFG = UGConfig(ef_spatial=16, ef_attribute=32, max_edges_if=12, max_edges_is=12,
               iterations=2, repair_width=8, exact_spatial=True, block=512)
D = 12


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small shapes: torch's intra-op pool would only contend with the other
    test processes, so this module runs torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_INDEX_CACHE: dict = {}


def small_index(n=300, seed=5):
    """Built once per (n, seed) and shared: updates are functional, so
    engines in different tests can all attach the same snapshot."""
    if (n, seed) not in _INDEX_CACHE:
        rng = np.random.default_rng(seed)
        x = rng.normal(size=(n, D)).astype(np.float32)
        ints = np.sort(rng.uniform(size=(n, 2)), axis=1).astype(np.float32)
        _INDEX_CACHE[n, seed] = UGIndex.build(x, ints, CFG, device="cpu")
    return _INDEX_CACHE[n, seed]


def make_engine(**kw):
    eng = ServeEngine()
    eng.attach_index(small_index(**kw))
    return eng


def make_queries(nq, seed=11):
    rng = np.random.default_rng(seed)
    qv = rng.normal(size=(nq, D)).astype(np.float32)
    c = rng.uniform(size=(nq, 1)).astype(np.float32)
    qi = np.concatenate([np.maximum(c - 0.3, 0), np.minimum(c + 0.3, 1)], axis=1)
    flags = [FLAG_IF if i % 2 else FLAG_IS for i in range(nq)]
    return qv, qi, flags


class FakeClock:
    """Injectable monotonic clock for deterministic deadline tests."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def direct_rows(index, qv, qi, flags, *, ef=64, k=10, sel=None):
    """Reference answers: one padded ``search_mixed`` over the selected rows,
    a batch composed differently from the runtime's micro-batches."""
    idxs = list(range(qv.shape[0])) if sel is None else list(sel)
    B = len(idxs)
    Bp = bucket_batch_size(B)
    q, w = pad_batch(torch.as_tensor(qv[idxs]), torch.as_tensor(qi[idxs]), Bp)
    f = pad_rows(torch.tensor([flags[i] for i in idxs], dtype=torch.int32), Bp, FLAG_IF)
    res = search_mixed(index.store, q, w, f, ef=ef, k=k)
    return res.ids[:B].numpy(), res.dist[:B].numpy()


def same(rep, ids, dist) -> bool:
    return np.array_equal(rep.ids, ids) and np.array_equal(rep.dist.view(np.int32),
                                                           dist.view(np.int32))


def store_tensors(index) -> dict:
    st = index.store
    out = dict(x=st.plane.data, intervals=st.intervals, nbrs=st.nbrs, status=st.status)
    for name in ("alive", "free"):
        if getattr(st, name) is not None:
            out[name] = getattr(st, name)
    for i, a in enumerate(st.entry.arrays()):
        out[f"entry{i}"] = a
    return out


# ---------------------------------------------------------------- exactness
def test_inline_coalesced_results_match_direct_search():
    eng = make_engine()
    rt = ServeRuntime(eng)
    qv, qi, flags = make_queries(13)  # odd count: pad rows
    futs = [rt.submit(qv[i], qi[i], flags[i]) for i in range(13)]
    assert rt.run_until_idle() >= 1
    ids, dist = direct_rows(eng.index, qv, qi, flags)
    for i, f in enumerate(futs):
        rep = f.result(timeout=5)
        assert same(rep, ids[i], dist[i])
        assert rep.index is eng.index
    assert rt.stats()["completed"] == 13


def test_mixed_compile_keys_split_into_exact_micro_batches():
    """Alternating (ef, k) breaks the stream into many tiny micro-batches;
    every reply still equals the direct call on its own key."""
    eng = make_engine()
    rt = ServeRuntime(eng)
    qv, qi, flags = make_queries(12)
    keys = [(32, 5), (64, 10)]
    futs = [rt.submit(qv[i], qi[i], flags[i], ef=keys[i % 2][0], k=keys[i % 2][1])
            for i in range(12)]
    rt.run_until_idle()
    for ef, k in keys:
        sel = [i for i in range(12) if keys[i % 2] == (ef, k)]
        ids, dist = direct_rows(eng.index, qv, qi, flags, ef=ef, k=k, sel=sel)
        for j, i in enumerate(sel):
            rep = futs[i].result(timeout=5)
            assert rep.ids.shape == (k,)
            assert same(rep, ids[j], dist[j])


def test_threaded_runtime_matches_direct_search():
    eng = make_engine()
    qv, qi, flags = make_queries(24)
    with ServeRuntime(eng, RuntimeConfig(max_batch=8)) as rt:
        futs = [rt.submit(qv[i], qi[i], flags[i]) for i in range(24)]
        reps = [f.result(timeout=60) for f in futs]
    ids, dist = direct_rows(eng.index, qv, qi, flags)
    for i, rep in enumerate(reps):
        assert same(rep, ids[i], dist[i])
    s = rt.stats()
    assert s["completed"] == 24 and s["rejected"] == 0
    assert s["p99_ms"] >= s["p50_ms"] > 0


# ----------------------------------------------------- snapshot consistency
def test_no_torn_reads_across_a_write():
    """FIFO contract: queries before the remove answer the old snapshot,
    queries after the new one, each bitwise equal to a direct search on the
    snapshot its reply pinned."""
    eng = make_engine()
    old_index = eng.index
    qv, qi, flags = make_queries(8)
    rt = ServeRuntime(eng)
    pre = [rt.submit(qv[i], qi[i], flags[i]) for i in range(8)]
    victim_ids = np.unique(direct_rows(old_index, qv, qi, flags)[0].ravel())
    victim_ids = victim_ids[victim_ids >= 0][:12]
    wfut = rt.submit_remove(victim_ids.astype(np.int32))
    post = [rt.submit(qv[i], qi[i], flags[i]) for i in range(8)]
    rt.run_until_idle()

    assert wfut.result(timeout=5) == len(victim_ids)
    new_index = eng.index
    assert new_index is not old_index
    ids_old, dist_old = direct_rows(old_index, qv, qi, flags)
    ids_new, dist_new = direct_rows(new_index, qv, qi, flags)
    for i in range(8):
        a, b = pre[i].result(timeout=5), post[i].result(timeout=5)
        assert a.index is old_index and b.index is new_index
        assert same(a, ids_old[i], dist_old[i])
        assert same(b, ids_new[i], dist_new[i])
    gone = set(victim_ids.tolist())
    for i in range(8):
        assert not gone & set(post[i].result().ids.tolist())
    assert rt.stats()["writes"] == 1


def test_count_pinned_matches_counts_replies_equal_to_their_snapshot():
    """The check ``bench_serve`` and ``chip_smoke.py`` share: every reply
    across a write matches its pinned snapshot; one with a flipped
    distance bit, or re-pinned to the other snapshot, does not."""
    eng = make_engine()
    old = eng.index
    qv, qi, flags = make_queries(8)
    # the remove takes the whole answer of post-write query j away
    ids_old = direct_rows(old, qv, qi, flags)[0]
    j = 4 + int(np.argmax((ids_old[4:] >= 0).sum(axis=1)))
    victims = ids_old[j][ids_old[j] >= 0]
    rt = ServeRuntime(eng)
    futs = [rt.submit(qv[i], qi[i], flags[i]) for i in range(4)]
    rt.submit_remove(victims.astype(np.int32))
    futs += [rt.submit(qv[i], qi[i], flags[i]) for i in range(4, 8)]
    rt.run_until_idle()
    replies = [f.result(timeout=5) for f in futs]
    rows = (torch.as_tensor(qv), torch.as_tensor(qi), torch.tensor(flags, dtype=torch.int32))
    assert count_pinned_matches(replies, *rows, ef=64, k=10) == 8
    bad = list(replies)
    bad[1] = bad[1]._replace(dist=(bad[1].dist.view(np.int32) ^ 1).view(np.float32))
    bad[j] = bad[j]._replace(index=old)
    assert count_pinned_matches(bad, *rows, ef=64, k=10) == 6


def test_upsert_through_runtime_is_visible_to_later_queries():
    eng = make_engine(n=256)
    old_index = eng.index
    rt = ServeRuntime(eng)
    xnew = np.random.default_rng(99).normal(size=(16, D)).astype(np.float32)
    inew = np.broadcast_to(np.asarray([0.0, 1.0], np.float32), (16, 2))
    qv, qi, flags = make_queries(4)
    pre = [rt.submit(qv[i], qi[i], flags[i]) for i in range(4)]
    wfut = rt.submit_upsert(xnew, inew)
    post = [rt.submit(qv[i], qi[i], flags[i]) for i in range(4)]
    rt.run_until_idle()
    assert wfut.result(timeout=5) == 16
    assert eng.index is not old_index and eng.index.n == 256 + 16
    for i in range(4):
        assert pre[i].result().index is old_index
        assert post[i].result().index is eng.index


def test_pre_write_snapshot_tensors_unchanged():
    """A remove and an upsert through the runtime write into no tensor of
    the snapshot they replace: every tensor of the pre-write store (entry
    structure included) keeps its bits, and a search on it still answers
    as before."""
    eng = make_engine()
    old = eng.index
    before = {k: v.clone() for k, v in store_tensors(old).items()}
    qv, qi, flags = make_queries(8)
    ids0, dist0 = direct_rows(old, qv, qi, flags)
    rt = ServeRuntime(eng)
    rt.submit_remove(np.arange(0, 40, 2, dtype=np.int32))
    rt.submit_upsert(np.random.default_rng(7).normal(size=(20, D)).astype(np.float32),
                     np.sort(np.random.default_rng(8).uniform(size=(20, 2)), 1).astype(np.float32))
    post = [rt.submit(qv[i], qi[i], flags[i]) for i in range(8)]
    rt.run_until_idle()
    assert rt.stats()["writes"] == 2 and post[0].result().index is eng.index is not old
    after = store_tensors(old)
    assert after.keys() == before.keys()
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    ids1, dist1 = direct_rows(old, qv, qi, flags)
    assert np.array_equal(ids0, ids1) and np.array_equal(dist0.view(np.int32),
                                                         dist1.view(np.int32))


@pytest.mark.parametrize("threaded", [False, True], ids=["inline", "threaded"])
def test_failed_write_leaves_the_index_and_the_next_write_applies_to_it(threaded, monkeypatch):
    """A remove that raises answers its future with the error and changes
    no snapshot; the upsert admitted after it applies to the index before
    it, and the queries after both pin that upsert's index."""
    def failing(self, ids, *, repair=True):
        raise RuntimeError("remove failed")
    monkeypatch.setattr(ServeEngine, "remove", failing)
    dead = np.arange(0, 40, 2, dtype=np.int32)
    xnew = np.random.default_rng(7).normal(size=(20, D)).astype(np.float32)
    inew = np.sort(np.random.default_rng(8).uniform(size=(20, 2)), 1).astype(np.float32)
    eng = make_engine()
    old = eng.index
    qv, qi, flags = make_queries(4)
    rt = ServeRuntime(eng, RuntimeConfig(max_batch=4))
    if threaded:
        rt.start()
    bad, good = rt.submit_remove(dead), rt.submit_upsert(xnew, inew)
    post = [rt.submit(qv[i], qi[i], flags[i]) for i in range(4)]
    if threaded:
        rt.stop()
    else:
        rt.run_until_idle()
    with pytest.raises(RuntimeError, match="remove failed"):
        bad.result(timeout=5)
    assert good.result(timeout=5) == len(xnew)
    assert eng.index.n == old.n + len(xnew) and rt.stats()["writes"] == 1
    ids, dist = direct_rows(eng.index, qv, qi, flags)
    for i, f in enumerate(post):
        assert f.result(timeout=5).index is eng.index and same(f.result(), ids[i], dist[i])


def test_engine_holds_the_attached_store_by_reference():
    idx = small_index()
    eng = ServeEngine()
    eng.attach_index(idx, width=2)
    assert eng.index is idx and eng.search_width == 2
    ptrs = [t.data_ptr() for t in store_tensors(idx).values()]
    qv, qi, flags = make_queries(5)
    res = eng.retrieve_mixed(None, qi, flags, q_v=qv)
    assert eng.index.store is idx.store
    assert [t.data_ptr() for t in store_tensors(eng.index).values()] == ptrs
    assert res.ids.shape == (5, 10) and res.steps.shape == (5,)


# ------------------------------------------------------ deadlines + bounds
def test_deadline_expired_at_admission_is_rejected():
    eng = make_engine()
    clk = FakeClock()
    rt = ServeRuntime(eng, clock=clk)
    qv, qi, flags = make_queries(1)
    fut = rt.submit(qv[0], qi[0], flags[0], deadline=clk() - 0.1)
    with pytest.raises(DeadlineExceeded):
        fut.result(timeout=1)
    assert rt.stats()["rejected"] == 1
    assert rt.run_until_idle() == 0  # nothing was enqueued


def test_deadline_expired_in_queue_is_rejected_not_dropped():
    eng = make_engine()
    clk = FakeClock()
    rt = ServeRuntime(eng, clock=clk)
    qv, qi, flags = make_queries(3)
    doomed = rt.submit(qv[0], qi[0], flags[0], deadline=clk() + 1.0)
    alive = [rt.submit(qv[i], qi[i], flags[i], deadline=clk() + 100.0) for i in (1, 2)]
    clk.advance(5.0)  # both queued; only the first expires
    rt.run_until_idle()
    with pytest.raises(DeadlineExceeded):
        doomed.result(timeout=1)
    ids, dist = direct_rows(eng.index, qv, qi, flags, sel=[1, 2])
    for j, f in enumerate(alive):
        assert same(f.result(timeout=5), ids[j], dist[j])
    s = rt.stats()
    assert s["rejected"] == 1 and s["completed"] == 2


def test_admission_bound_raises_queue_full():
    eng = make_engine()
    rt = ServeRuntime(eng, RuntimeConfig(max_queue=2))
    qv, qi, flags = make_queries(3)
    rt.submit(qv[0], qi[0], flags[0])
    rt.submit(qv[1], qi[1], flags[1])
    with pytest.raises(QueueFull):
        rt.submit(qv[2], qi[2], flags[2])
    rt.run_until_idle()  # the two admitted requests still complete
    assert rt.stats()["completed"] == 2


def test_runtime_requires_an_attached_index():
    with pytest.raises(ValueError):
        ServeRuntime(ServeEngine())


# -------------------------------------------------- empty batches + chunks
def test_empty_batches_never_dispatch():
    eng = make_engine()
    assert eng.remove(np.zeros((0,), np.int32)) == 0
    assert eng.upsert(None, np.zeros((0, 2), np.float32), x=np.zeros((0, D), np.float32)) == 0
    res = eng.retrieve_mixed(None, np.zeros((0, 2), np.float32), [], k=7,
                             q_v=np.zeros((0, D), np.float32))
    assert res.ids.shape == (0, 7) and res.dist.shape == (0, 7)
    with pytest.raises(ValueError):
        bucket_batch_size(0)
    with pytest.raises(ValueError):
        bucket_batch_size(-3)
    with pytest.raises(ValueError, match="no model"):
        eng.retrieve_mixed(np.zeros((1, 4), np.int32), np.zeros((1, 2), np.float32), [FLAG_IF])


def test_upsert_chunk_plan_shapes_and_coverage():
    for n_live, total in [(300, 16), (300, 500), (64, 1000), (10_000, 3000), (0, 64), (5, 1)]:
        plan = upsert_chunk_plan(n_live, total)
        assert sum(plan) == total
        top = BATCH_BUCKETS[-1]
        for b in plan[:-1]:  # the tail chunk may be a remnant
            assert b in BATCH_BUCKETS or b % top == 0, (n_live, total, plan)
        live = n_live
        for b in plan:       # chunk i never exceeds half the live count (floor 64)
            assert b <= max(live // 2, 64)
            live += b
    assert upsert_chunk_plan(300, 0) == []


def _counting_n(monkeypatch):
    calls = {"n": 0}
    orig = UGIndex.n.fget

    def counting_n(self):
        calls["n"] += 1
        return orig(self)

    monkeypatch.setattr(UGIndex, "n", property(counting_n))
    return calls


def test_upsert_reads_liveness_exactly_once(monkeypatch):
    eng = make_engine(n=256)
    calls = _counting_n(monkeypatch)
    x = np.random.default_rng(3).normal(size=(700, D)).astype(np.float32)
    ints = np.broadcast_to(np.asarray([0.0, 1.0], np.float32), (700, 2))
    assert eng.upsert(None, ints, x=x) == 700  # several chunks, one read
    assert calls["n"] == 1


def test_runtime_writer_reuses_engine_chunk_plan(monkeypatch):
    """The runtime's writes go through ServeEngine.upsert and inherit its
    single-read chunk plan."""
    eng = make_engine(n=256)
    calls = _counting_n(monkeypatch)
    rt = ServeRuntime(eng)
    x = np.random.default_rng(4).normal(size=(400, D)).astype(np.float32)
    ints = np.broadcast_to(np.asarray([0.0, 1.0], np.float32), (400, 2))
    fut = rt.submit_upsert(x, ints)
    rt.run_until_idle()
    assert fut.result(timeout=5) == 400
    assert calls["n"] == 1


# ------------------------------------------------- the reference's numbers
GRID = [(n_live, total) for n_live in (0, 1, 5, 63, 64, 128, 300, 2047, 2048, 5000, 10_000)
        for total in (-1, 0, 1, 7, 64, 500, 1000, 3000)]


@pytest.mark.parametrize("n_live,total", GRID)
def test_chunk_plan_and_buckets_match_reference(n_live, total):
    assert upsert_chunk_plan(n_live, total) == ref_engine.upsert_chunk_plan(n_live, total)
    assert BATCH_BUCKETS == ref_engine.BATCH_BUCKETS
    for b in (n_live, total, n_live + total):
        try:
            want = ref_engine.bucket_batch_size(b)
        except ValueError:
            with pytest.raises(ValueError):
                bucket_batch_size(b)
        else:
            assert bucket_batch_size(b) == want


@pytest.mark.parametrize("cap,seed", [(1, 0), (7, 3), (100, 0), (4096, 1)])
def test_latency_reservoir_matches_reference(cap, seed):
    stream = np.random.default_rng(seed).exponential(size=12_000).tolist()
    ours, ref = LatencyReservoir(cap, seed=seed), ref_runtime.LatencyReservoir(cap, seed=seed)
    ours.extend(stream[:5000])
    ref.extend(stream[:5000])
    for x in stream[5000:]:
        ours.offer(x)
        ref.offer(x)
    assert list(ours) == list(ref) and ours.seen == ref.seen and len(ours) == len(ref)
    for q in (0.0, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert _pctl(sorted(ours), q) == ref_runtime._pctl(sorted(ref), q)


# ------------------------------------------------------------------- stats
def test_pctl_nearest_rank_known_quantiles():
    assert _pctl([], 0.5) == 0.0
    assert _pctl([7.0], 0.5) == 7.0
    assert _pctl([1.0, 2.0], 0.5) == 1.0
    xs = [1.0, 2.0, 3.0, 4.0]
    assert [_pctl(xs, q) for q in (0.25, 0.5, 0.75, 0.99, 1.0)] == [1.0, 2.0, 3.0, 4.0, 4.0]
    hundred = [float(i) for i in range(1, 101)]
    assert (_pctl(hundred, 0.5), _pctl(hundred, 0.99), _pctl(hundred, 0.999)) == (50.0, 99.0,
                                                                                  100.0)


def test_latency_reservoir_bounds_memory_and_samples_uniformly():
    r = LatencyReservoir(100, seed=0)
    for i in range(10_000):
        r.offer(float(i))
    assert len(r) == 100 and r.seen == 10_000
    vals = sorted(r)
    assert all(0.0 <= v < 10_000 for v in vals)
    assert vals[0] < 2_000 and vals[-1] > 8_000
    r2 = LatencyReservoir(100, seed=0)
    r2.extend(float(i) for i in range(10_000))
    assert sorted(r2) == vals
    r3 = LatencyReservoir(100)
    r3.extend([3.0, 1.0, 2.0])
    assert sorted(r3) == [1.0, 2.0, 3.0]
    with pytest.raises(ValueError):
        LatencyReservoir(0)


def test_runtime_latencies_are_bounded():
    assert isinstance(ServeRuntime(make_engine())._latencies, LatencyReservoir)


def test_stats_wall_clock_covers_active_windows_only():
    """QPS counts start/stop windows (and run_until_idle pumps), not time
    since construction: idle time before, between and after windows does
    not dilute it."""
    eng = make_engine()
    clk = FakeClock()
    qv, qi, flags = make_queries(8)
    rt = ServeRuntime(eng, RuntimeConfig(max_batch=8), clock=clk)
    clk.advance(500.0)                 # idle before serving starts
    rt.start()
    for f in [rt.submit(qv[i], qi[i], flags[i]) for i in range(8)]:
        f.result(timeout=120)
    clk.advance(2.0)                   # the only active wall time
    rt.stop()
    clk.advance(500.0)                 # idle after stop
    s = rt.stats()
    assert s["completed"] == 8
    assert s["qps"] == pytest.approx(8 / 2.0)

    rt.start()                         # a second window extends the first
    for f in [rt.submit(qv[i], qi[i], flags[i]) for i in range(8)]:
        f.result(timeout=120)
    clk.advance(3.0)
    rt.stop()
    s = rt.stats()
    assert s["completed"] == 16
    assert s["qps"] == pytest.approx(16 / 5.0)


def test_stats_wall_clock_inline_mode():
    """Inline pumps count their own wall time; idle time between
    construction and the pump does not enter the QPS denominator."""
    eng = make_engine()
    clk = FakeClock()
    rt = ServeRuntime(eng, clock=clk)
    qv, qi, flags = make_queries(5)
    clk.advance(1000.0)
    for i in range(5):
        rt.submit(qv[i], qi[i], flags[i])
    rt.run_until_idle()
    s = rt.stats()
    assert s["completed"] == 5
    assert s["qps"] > 5.0  # the fake clock stands still inside the pump


# ------------------------------------------------------------ bench tables
def test_serve_and_updates_tables_emit_reference_rows(monkeypatch):
    """The ``serve`` and ``updates`` tables on the CPU at a small size carry
    the reference's row names (the profile rows under the port's backend
    names), and the serve table's consistency rows read 1.0."""
    from repro_torch.bench import common, tables

    monkeypatch.setattr(common, "TIMED_CALLS", (0, 1))   # the rows matter here, not the times
    b = common.Bench(n=300, dim=D, nq=8, device="cpu", cfg=CFG)
    serve = tables.bench_serve(b, nreq=32, batch=8, timed_seconds=0.0)   # one round
    assert [r["name"] for r in serve] == ["serve_sync_batched", "serve_async_runtime",
                                          "serve_consistency"]
    cons = serve[2]["metrics"]
    assert cons["recall_vs_pinned_snapshot"] == cons["recall_async_eq_sync"] == 1.0
    assert serve[1]["metrics"]["writes"] == 2 and serve[1]["metrics"]["rejected"] == 0
    assert serve[1]["metrics"]["rounds"] == 1
    updates = tables.bench_updates(b, require_recall_gap=1.0)
    assert [r["name"] for r in updates] == [
        "updates_profile_legacy", "updates_profile_torch", "updates_delete_batch",
        "updates_insert_batch", "updates_churn_if", "updates_churn_is", "updates_churn_rs",
        "updates_churn_rf"]
    assert updates[0]["metrics"]["quadratic_cc"] is True
    assert updates[1]["metrics"]["quadratic_cc"] is False
    assert updates[3]["metrics"]["batch"] == 30 and updates[2]["metrics"]["live"] == 300
