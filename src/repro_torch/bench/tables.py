"""One bench function per paper table, as in the reference's
``benchmarks/tables.py``, with the same row names.

Each returns rows (``common.row``): name, us_per_call, derived, and the
unrounded metrics behind ``derived``.  Ported so far: Exp-1 (IFANN against
the baselines), Exp-2 (query types), Exp-3 (workloads), Exp-4 (indexing),
Exp-5 (varying k) and the kernel table.
"""
from __future__ import annotations

import torch

from repro_torch.bench import common
from repro_torch.core import Semantics, recall
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
