"""One bench function per paper table, as in the reference's
``benchmarks/tables.py``, with the same row names.

Each returns rows (``common.row``): name, us_per_call, derived, and the
unrounded metrics behind ``derived``.  Ported so far: Exp-1 (IFANN against
the baselines), Exp-2 (query types), Exp-3 (workloads), Exp-4 (indexing),
Exp-5 (varying k), the streaming updates, the serve runtime and the kernel
table.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.bench import common
from repro_torch.core import Semantics, SearchResult, UGIndex, recall
from repro_torch.core import intervals as iv_mod
from repro_torch.core.baselines import prefilter_search
from repro_torch.kernels import ops
from repro_torch.kernels.expand_score import expand_score_legacy
from repro_torch.kernels.util import no_tf32, resolve_device


def _qps_row(name: str, nq: int, dt: float, r: float) -> dict:
    qps = nq / dt
    return common.row(name, 1e6 * dt / nq, f"recall={r:.3f} qps={qps:.0f}", qps=qps, recall=r)


# ---------------------------------------------------------------- Exp-1 / Fig 6
def bench_ifann(b: common.Bench):
    """IFANN QPS–recall trade-off: UG vs post-filter vs Hi-PNG vs pre-filter."""
    rows = []
    dev = b.device
    qv, qi = b.queries("uniform")
    ug = b.ug_index()
    pf = b.postfilter_index()
    hp = b.hipng_index()
    gt = ug.ground_truth(qv, qi, sem=Semantics.IF, k=10)
    nq = qv.shape[0]

    for ef in (16, 32, 64, 128):
        qps, r = common.qps_recall(ug, qv, qi, sem=Semantics.IF, ef=ef, truth=gt)
        rows.append(_qps_row(f"ifann_ug_ef{ef}", nq, nq / qps, r))
    for ef in (32, 128):
        dt, res = common.timed(
            lambda: pf.search(qv, qi, sem=Semantics.IF, ef=ef, k=10, oversample=8), device=dev)
        rows.append(_qps_row(f"ifann_postfilter_ef{ef}", nq, dt, recall(res, gt)))
    dt, res = common.timed(lambda: hp.search(qv, qi, ef=64, k=10), device=dev)
    rows.append(_qps_row("ifann_hipng_ef64", nq, dt, recall(res, gt)))
    x, ints = b.corpus()
    dt, res = common.timed(
        lambda: prefilter_search(x, ints, qv, qi, sem=Semantics.IF, k=10), device=dev)
    rows.append(_qps_row("ifann_prefilter_exact", nq, dt, recall(res, gt)))
    return rows


# ---------------------------------------------------------------- Exp-2 / Fig 7
def bench_query_types(b: common.Bench):
    """One UG index answering all four semantics (the paper's headline)."""
    rows = []
    ug = b.ug_index()
    qv, qi = b.queries("uniform")
    _, qpoint = b.queries("point")
    for sem, q in [(Semantics.IF, qi), (Semantics.IS, qi), (Semantics.RS, qpoint),
                   (Semantics.RF, qi)]:
        qps, r = common.qps_recall(ug, qv, q, sem=sem, ef=96)
        rows.append(_qps_row(f"qtype_{sem.value.lower()}", qv.shape[0], qv.shape[0] / qps, r))
    return rows


# ---------------------------------------------------------------- Exp-3 / Fig 10
def bench_workloads(b: common.Bench):
    """IFANN under short/long/mixed/uniform selectivity workloads."""
    rows = []
    ug = b.ug_index()
    for w in ("short", "long", "mixed", "uniform"):
        qv, qi = b.queries(w)
        qps, r = common.qps_recall(ug, qv, qi, sem=Semantics.IF, ef=96)
        rows.append(_qps_row(f"workload_{w}", qv.shape[0], qv.shape[0] / qps, r))
    return rows


# ---------------------------------------------------------------- Exp-4 / Fig 8+9
def bench_indexing(b: common.Bench):
    """Index construction time and memory for UG vs baselines."""
    rows = []
    ug = b.ug_index()
    sec, nbytes = ug.build_seconds, ug.memory_bytes()
    rows.append(common.row("index_build_ug", sec * 1e6, f"seconds={sec:.1f} bytes={nbytes:,}",
                           seconds=sec, bytes=nbytes))
    pf = b.postfilter_index()
    sec, nbytes = pf.build_seconds, pf.memory_bytes()
    rows.append(common.row("index_build_postfilter", sec * 1e6,
                           f"seconds={sec:.1f} bytes={nbytes:,}", seconds=sec, bytes=nbytes))
    hp = b.hipng_index()
    sec, nbytes, parts = hp.build_seconds, hp.memory_bytes(), len(hp.partitions)
    rows.append(common.row("index_build_hipng", sec * 1e6,
                           f"seconds={sec:.1f} bytes={nbytes:,} partitions={parts}",
                           seconds=sec, bytes=nbytes, partitions=parts))
    d = ug.degree_stats()
    rows.append(common.row(
        "index_degrees_ug", 0.0,
        f"mean_if={d['mean_if']:.1f} mean_is={d['mean_is']:.1f} edges={d['edges']}", **d))
    return rows


# ---------------------------------------------------------------- Exp-5 / Fig 12
def bench_k(b: common.Bench):
    rows = []
    ug = b.ug_index()
    qv, qi = b.queries("uniform")
    for k in (1, 10, 20, 50):
        qps, r = common.qps_recall(ug, qv, qi, sem=Semantics.IF, ef=max(96, 2 * k), k=k)
        rows.append(_qps_row(f"vary_k_{k}", qv.shape[0], qv.shape[0] / qps, r))
    return rows


# ------------------------------------------------- streaming updates (churn)
def bench_updates(b: common.Bench, churn: float = 0.1, require_recall_gap=None):
    """Streaming updates: churn throughput and recall against a fresh
    rebuild under all four semantics.

    Deletes ``churn·n`` random nodes (tombstone and repair), inserts
    ``churn·n`` Gaussian rows with uniform intervals, and compares
    recall@10 of the mutated index with a build over the same live corpus.
    ``require_recall_gap`` asserts ``recall_mutated ≥ recall_fresh − gap``
    a semantics.  The memory profile of the insert and repair steps must
    show no ``(·, C, C)`` witness or dedup tensor and no ``(B, C, d)``
    gather on the plain versions, nor (on the card) on the kernels.  The
    reference's ``legacy`` row needs the legacy sweep (ROADMAP queue 1
    item 2)."""
    from repro_torch.core.updates import update_memory_profile

    dev = b.device
    rows = []
    for backend in ("torch", "cuda") if dev.type == "cuda" else ("torch",):
        prof = update_memory_profile(backend)
        if prof["quadratic_cc"] or prof["gather_bcd"]:
            raise AssertionError(f"{backend} update path materializes a quadratic intermediate")
        rows.append(common.row(
            f"updates_profile_{backend}", 0.0,
            f"peak_intermediate_bytes={prof['peak_bytes']} "
            f"cc_witness={'yes' if prof['quadratic_cc'] else 'no'} "
            f"bcd_gather={'yes' if prof['gather_bcd'] else 'no'}", **prof))

    x, ints = b.corpus()
    n = x.shape[0]
    nb = max(int(n * churn), 1)
    g = torch.Generator(device=dev).manual_seed(1234)
    new_x = torch.randn(nb, x.shape[1], generator=g, device=dev)
    new_iv = iv_mod.sample_uniform_intervals(g, nb)
    dels = np.random.default_rng(42).choice(n, size=nb, replace=False).astype(np.int32)
    idx0 = b.ug_index()

    dt_del, idx_d = common.timed(lambda: idx0.delete(dels), device=dev)
    dt_ins, idx_m = common.timed(lambda: idx_d.insert(new_x, new_iv), device=dev)
    rows.append(common.row(
        "updates_delete_batch", 1e6 * dt_del / nb,
        f"deletes_per_s={nb / dt_del:.0f} batch={nb} live={idx_m.n}",
        seconds=dt_del, batch=nb, live=idx_m.n))
    rows.append(common.row(
        "updates_insert_batch", 1e6 * dt_ins / nb,
        f"inserts_per_s={nb / dt_ins:.0f} batch={nb} capacity={idx_m.capacity}",
        seconds=dt_ins, batch=nb, capacity=idx_m.capacity))

    # a fresh build over the mutated corpus: the recall yardstick
    keep = torch.as_tensor(np.setdiff1d(np.arange(n), dels), device=dev)
    idx_f = UGIndex.build(torch.cat([x[keep], new_x]), torch.cat([ints[keep], new_iv]),
                          b.config, device=dev)
    qv, qi = b.queries("uniform")
    _, qpoint = b.queries("point")
    worst = 0.0
    for sem, q in [(Semantics.IF, qi), (Semantics.IS, qi), (Semantics.RS, qpoint),
                   (Semantics.RF, qi)]:
        dt_q, res = common.timed(lambda: idx_m.search(qv, q, sem=sem, ef=96, k=10), device=dev)
        r_mut = recall(res, idx_m.ground_truth(qv, q, sem=sem, k=10))
        r_fresh = recall(idx_f.search(qv, q, sem=sem, ef=96, k=10),
                         idx_f.ground_truth(qv, q, sem=sem, k=10))
        gap = r_fresh - r_mut
        worst = max(worst, gap)
        qps = qv.shape[0] / dt_q
        rows.append(common.row(
            f"updates_churn_{sem.value.lower()}", 1e6 * dt_q / qv.shape[0],
            f"recall={r_mut:.3f} recall_fresh_rebuild={r_fresh:.3f} gap={gap:+.3f} "
            f"qps={qps:.0f}", recall=r_mut, recall_fresh_rebuild=r_fresh, gap=gap, qps=qps))
    if require_recall_gap is not None and worst > require_recall_gap:
        raise AssertionError(f"churned-index recall trails a fresh rebuild by {worst:.3f} "
                             f"(allowed {require_recall_gap})")
    return rows


# ------------------------------------------------------- async serve runtime
def bench_serve(b: common.Bench, nreq: int = 256, batch: int = 64, require_qps_ratio=None):
    """The continuous-batching runtime against the sync batched path on a
    churning mixed IF/IS/RF/RS workload.

    One request stream, served twice from the same index: the sync path
    runs FIFO batches of ``batch`` through ``retrieve_mixed`` (blocking a
    batch), the async path submits the same requests one at a time to a
    threaded :class:`~repro_torch.serve.ServeRuntime`.  Halfway, both apply
    the same write (a remove and an upsert of ``n // 20`` rows).  Updates
    are deterministic, so both paths' post-write snapshots are equal, and
    the consistency metrics are exact:

    * ``recall_vs_pinned_snapshot``: the share of async replies bitwise
      equal to a direct padded ``search_mixed`` on their pinned snapshot
      (1.0 = no torn reads);
    * ``recall_async_eq_sync``: the share of requests whose async and sync
      answers agree bitwise (continuous batching is exact);
    * ``recall_pre``/``recall_post``: recall@10 of each half of the stream
      against its own snapshot's exact truth.

    The async client submits every request at once (no arrival rate), so
    the runtime row's p50/p99 measure queue position, not a user's latency
    at a given load.  ``require_qps_ratio`` asserts
    ``qps_async ≥ ratio · qps_sync``."""
    from repro_torch.data import CorpusConfig, make_queries
    from repro_torch.serve import RuntimeConfig, ServeEngine, ServeRuntime
    from repro_torch.serve.runtime import count_pinned_matches

    dev = b.device
    ef, k = 64, 10
    x, _ = b.corpus()
    n = x.shape[0]
    idx0 = b.ug_index()

    cycle = [Semantics.IF, Semantics.IS, Semantics.RS, Semantics.RF]
    sems = [cycle[i % 4] for i in range(nreq)]
    ccfg = CorpusConfig(n=b.n, dim=b.dim)
    qv, q_wide = make_queries(ccfg, nreq, workload="uniform", device=dev)
    _, q_point = make_queries(ccfg, nreq, workload="point", device=dev)
    flags = iv_mod.as_sem_flags(sems, nreq, device=dev)
    is_rs = torch.tensor([s is Semantics.RS for s in sems], device=dev)
    qw = torch.where(is_rs[:, None], q_point, q_wide)

    b_churn = max(n // 20, 8)
    dels = np.random.default_rng(77).choice(n, size=b_churn, replace=False).astype(np.int32)
    g = torch.Generator(device=dev).manual_seed(4321)
    new_x = torch.randn(b_churn, x.shape[1], generator=g, device=dev)
    new_iv = iv_mod.sample_uniform_intervals(g, b_churn)
    mid = (nreq // batch // 2) * batch

    def serve_sync(engine):
        """FIFO batches, blocking a batch; the write between two batches."""
        out_ids, out_dist = [], []
        t0 = time.perf_counter()
        for s in range(0, nreq, batch):
            if s == mid:
                engine.remove(dels)
                engine.upsert(None, new_iv, x=new_x)
            res = engine.retrieve_mixed(None, qw[s:s + batch], sems[s:s + batch], ef=ef, k=k,
                                        q_v=qv[s:s + batch])
            out_ids.append(res.ids.cpu().numpy())          # blocks: sync semantics
            out_dist.append(res.dist.cpu().numpy())
        dt = time.perf_counter() - t0
        return np.concatenate(out_ids), np.concatenate(out_dist), dt

    # warm-up: the kernels' library and the allocator, on a scratch engine
    ServeEngine(index=idx0).retrieve_mixed(None, qw[:batch], sems[:batch], ef=ef, k=k,
                                           q_v=qv[:batch])
    common.synchronize(dev)

    eng_sync = ServeEngine(index=idx0)
    ids_sync, dist_sync, dt_sync = serve_sync(eng_sync)
    qps_sync = nreq / dt_sync

    eng_async = ServeEngine(index=idx0)
    # requests arrive as rows in host memory; made before the clock starts
    q_rows, w_rows = qv.cpu().numpy(), qw.cpu().numpy()
    t0 = time.perf_counter()
    with ServeRuntime(eng_async, RuntimeConfig(max_batch=batch)) as rt:
        futs, wfuts = [], []
        for i in range(nreq):
            if i == mid:
                wfuts.append(rt.submit_remove(dels))
                wfuts.append(rt.submit_upsert(new_x, new_iv))
            futs.append(rt.submit(q_rows[i], w_rows[i], sems[i], ef=ef, k=k,
                                  deadline=rt.clock() + 300.0))
        replies = [f.result(timeout=600) for f in futs]
        stats = rt.stats()
    dt_async = time.perf_counter() - t0
    qps_async = nreq / dt_async
    if not (all(w.result(timeout=5) == b_churn for w in wfuts)
            and stats["rejected"] == 0 and stats["writes"] == 2):
        raise AssertionError(f"async serve: writes or rejections off: {stats}")

    # consistency: every async reply equals a direct search on its pinned
    # snapshot, and async equals sync a request (both bitwise)
    frac_pinned = count_pinned_matches(replies, qv, qw, flags, ef=ef, k=k) / nreq
    frac_eq = sum(np.array_equal(r.ids, ids_sync[i])
                  and np.array_equal(r.dist.view(np.int32), dist_sync[i].view(np.int32))
                  for i, r in enumerate(replies)) / nreq
    if frac_pinned != 1.0:
        raise AssertionError(f"torn read: only {frac_pinned:.3f} of async replies match a "
                             f"direct search on their pinned snapshot")
    if frac_eq != 1.0:
        raise AssertionError(f"async/sync divergence: only {frac_eq:.3f} of requests agree")

    # recall of each half of the stream against its own snapshot's truth
    rec = {}
    for name, index, span in (("pre", idx0, range(0, mid)),
                              ("post", eng_async.index, range(mid, nreq))):
        hit = 0.0
        for s in cycle:
            ssel = [i for i in span if sems[i] is s]
            if not ssel:
                continue
            a = torch.as_tensor(ssel, device=dev)
            part = SearchResult(torch.as_tensor(np.stack([replies[i].ids for i in ssel])),
                                torch.as_tensor(np.stack([replies[i].dist for i in ssel])),
                                None)
            hit += recall(part, index.ground_truth(qv[a], qw[a], sem=s, k=k)) * len(ssel)
        rec[name] = hit / len(span)

    ratio = qps_async / qps_sync
    if require_qps_ratio is not None and ratio < require_qps_ratio:
        raise AssertionError(f"async runtime sustains only {ratio:.2f}x the sync batched QPS "
                             f"(need >= {require_qps_ratio}x)")
    return [
        common.row(
            "serve_sync_batched", 1e6 * dt_sync / nreq,
            f"qps={qps_sync:.0f} batch={batch} nreq={nreq} churn={b_churn}",
            qps=qps_sync, seconds=dt_sync, batch=batch, nreq=nreq, churn=b_churn),
        common.row(
            "serve_async_runtime", 1e6 * dt_async / nreq,
            f"qps={qps_async:.0f} qps_ratio={ratio:.2f} "
            f"p50_ms={stats['p50_ms']:.1f} p99_ms={stats['p99_ms']:.1f} "
            f"rejected={stats['rejected']} writes={stats['writes']}",
            qps=qps_async, qps_ratio=ratio, seconds=dt_async, p50_ms=stats["p50_ms"],
            p99_ms=stats["p99_ms"], rejected=stats["rejected"], writes=stats["writes"]),
        common.row(
            "serve_consistency", 0.0,
            f"recall_vs_pinned_snapshot={frac_pinned:.3f} "
            f"recall_async_eq_sync={frac_eq:.3f} "
            f"recall_pre={rec['pre']:.3f} recall_post={rec['post']:.3f}",
            recall_vs_pinned_snapshot=frac_pinned, recall_async_eq_sync=frac_eq,
            recall_pre=rec["pre"], recall_post=rec["post"]),
    ]


# ---------------------------------------------------------------- kernels
def _kernel_inputs(nq: int, nx: int, d: int, device, seed: int = 0):
    """The reference's kernel-bench inputs, drawn on ``device``: Gaussian
    queries and corpus, sorted uniform object intervals, query windows of
    half-width 0.3."""
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(nq, d, generator=g, device=device)
    x = torch.randn(nx, d, generator=g, device=device)
    oi = torch.sort(torch.rand(nx, 2, generator=g, device=device), dim=1).values
    c = torch.rand(nq, 1, generator=g, device=device)
    qi = torch.cat([torch.clamp_min(c - 0.3, 0.0), torch.clamp_max(c + 0.3, 1.0)], dim=1)
    return q, x, oi, qi


def bench_kernels(nq: int = 64, nx: int = 4096, d: int = 128, *, device=None, data=None,
                  l2_nx: int | None = None, plain_nq: int | None = None):
    """The scan kernels and the expand-score kernel beside their plain
    versions (the reference's 64 × 4096 × 128 by default), top-10 scans.

    ``data=(q, x, obj_int, q_int)`` replaces the random inputs; the
    pairwise rows use the first ``l2_nx`` corpus rows and the plain scan
    the first ``plain_nq`` queries (both default to all).  The CUDA rows
    exist on the card only.  Times are host clocks around synchronized
    calls, median of three."""
    dev = resolve_device(device)
    no_tf32()
    q, x, oi, qi = _kernel_inputs(nq, nx, d, dev) if data is None else data
    nq, nx, d = q.shape[0], x.shape[0], q.shape[1]
    x_l2 = x[: l2_nx or nx]
    qp = q[: plain_nq or nq]
    on_card = dev.type == "cuda"
    rows = []

    def add(name, fn, nq_run, nx_run, what):
        dt, _ = common.timed(fn, device=dev)
        shape = f"{nq_run}x{nx_run}x{d}"
        rows.append(common.row(name, dt * 1e6, f"{what} {shape}", seconds=dt, nq=nq_run,
                               nx=nx_run, d=d))

    add("kernel_l2dist_torch_plain", lambda: ops.pairwise_sq_dist(q, x_l2, backend="torch"),
        nq, x_l2.shape[0], "plain version")
    if on_card:
        add("kernel_l2dist_cuda", lambda: ops.pairwise_sq_dist(q, x_l2, backend="cuda"),
            nq, x_l2.shape[0], "CUDA kernel")
    scan = dict(is_filter=True, k=10)
    add("kernel_fusedscan_torch_plain",
        lambda: ops.filtered_topk(qp, x, oi, qi[: qp.shape[0]], backend="torch", **scan),
        qp.shape[0], nx, "plain version")
    if on_card:
        add("kernel_fusedscan_cuda",
            lambda: ops.filtered_topk(q, x, oi, qi, backend="cuda", **scan), nq, nx,
            "CUDA kernel")
    g = torch.Generator(device=dev).manual_seed(1)
    idx = torch.randint(0, nx, (nq, 32), generator=g, device=dev, dtype=torch.int32)
    if on_card:
        add("kernel_gatherdist_cuda", lambda: ops.gather_sq_dist(x, idx, q, backend="cuda"),
            nq, 32, "CUDA kernel (expand_score)")
    add("kernel_expandscore_torch_plain", lambda: ops.expand_score(x, idx, q, backend="torch"),
        nq, 32, "plain version (bit-identical)")
    add("kernel_expandscore_legacy", lambda: expand_score_legacy(x, idx, q), nq, 32,
        "(B,C,d) gather + matmul baseline")
    return rows
