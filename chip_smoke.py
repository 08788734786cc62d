#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

    python3 chip_smoke.py            # from the root of a checkout, one card

Phases (each prints one JSON object per line; any failed check raises and
the script exits non-zero without printing a result):

0. the card: name and power limit, TF32 off;
1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc, one
   process per source) and print their ``-Xptxas -v`` report;
2. each kernel at the main path's shapes, held bitwise against its plain
   PyTorch version and timed with CUDA events beside its plain version, its
   bound and, where one exists, a single PyTorch call that computes the
   same function; ``beam_merge`` also at L = 2048 (the paper's degree
   256 + 256 at W = 4), bitwise, its time and bound under ``paper_degree``;
3. the main path at full size: ``make_corpus`` (n = 1,000,000, d = 128,
   SIFT1M's size and width) → ``UGIndex.build`` with the build CLI's
   defaults → ``UGIndex.search_mixed`` over 10,000 queries cycling
   IF/IS/RS/RF at ef = 64, k = 10, W = 4, timed over several batches;
   recall@10 against the port's exact ``brute_force``, for those queries
   (``make_queries`` draws their cluster centres apart from the corpus's, as
   the reference does) at ef = 64 and at wider beams, and for queries drawn
   around corpus rows;
4. path checks: every kernel of the f32 path launched during phase 3; the
   kernel path equals the plain path bitwise for search and for a
   50,000-row build; a mixed batch equals four per-semantics batches;
   recall tripwires (a broken graph or kernel gives ~0): mean recall@10
   ≥ 0.2 over the four semantics on the 50,000-row index, where this
   synthetic workload still allows it, and ≥ 0.02 on the 1M index (chance
   is ~1e-5 there); the 50,000-row index's recall beside that of an
   exact-KNN (``exact_spatial``) build of the same corpus;
5. the quantized path at full width: phase 3's 1M index re-encoded with
   ``UGIndex.with_dtype`` to a bf16 plane (no rerank), an int8 plane and a
   pq plane (both with the f32 rerank plane), the same graph; for each,
   bytes, encode (and pq training) time, QPS over the same 10,000 mixed
   queries, recall@10 against phase 3's exact truth, launches of its
   kernels (counted from 0 over its warm-up and timed batches); checks on
   1,000 queries (``backend="cuda"`` equals ``"torch"`` bitwise, the mixed
   batch equals four per-semantics batches) and a tripwire on the
   50,000-row index: mean recall@10 ≥ half of the f32 plane's;
6. the paper-table bench path at full width, on phase 3's corpus, config
   and index: (a) ``pairwise_sq_dist`` at 10,000 queries × 65,536 corpus
   rows × 128, f32 and bf16, within its stated bound of its plain version
   (``|kernel − plain| ≤ (d + 4)·2⁻²³·(‖q‖² + ‖x‖²)``: the product runs on
   the tensor cores, 3×TF32 for f32) with the largest error over the norms
   printed, and bitwise on integer data at 1,000 × 8,192 × 128; bf16 and
   ``torch.cdist`` timed; (b) ``filtered_topk`` (k = 10, IF and IS,
   uniform windows; its product also runs on the tensor cores) within its
   stated rule of its plain version (``fused_scan.rule_violations``) on
   1,000 queries against the whole 1M corpus and at a ragged small shape
   (77 × 3,001, k ∈ {1, 64}), bitwise on integer data at 1,000 × 65,536 ×
   128, f32 and bf16; its bf16 entry and ``brute_force`` timed on all
   10,000 queries; (c) the scan against ``prefilter_search``
   on those 1,000 queries; (d) Exp-1 and Exp-4 through ``repro_torch.bench``
   (post-filter and Hi-PNG builds at 1M, IF search of the 10,000 queries,
   the kernel table at these shapes, whose rows give both kernels' times:
   each kernel on all 10,000 queries, the plain scan on the first 1,000)
   with its launches counted from 0, and tripwires: every post-filter and
   Hi-PNG answer passes the predicate, the pre-filter's recall is 1, the
   post-filter's ``backend="cuda"`` equals ``"torch"``; (e) ``build_exact``
   at n = 1,000: prune backends cuda and torch give the same graph, and one
   structural-heredity check (Thm 3.5) holds;
7. streaming updates at full width on the kernels: (a) 10 % churn of phase
   4's 50,000-row index (5,000 random live ids deleted with repair, then
   5,000 new rows from the corpus's own mixture inserted, as the
   reference's churn contract draws them): ``backend="cuda"`` equals
   ``"torch"`` bitwise on every store array after the delete and after the
   insert, no deleted id surfaces, the capacity is unchanged (slots
   reused), recall@10 per semantics at ef = 64 over 1,000 queries a
   semantics is at least that of a fresh build of the same live set minus
   0.02, and ``compact()`` gives the same answer sets after id remapping;
   beside it, measured and not held to a bar, the same churn with 5,000
   rows of ``make_corpus`` with another seed (new cluster centres, which
   one batch of mutually invisible rows cannot wire among themselves)
   against its own fresh build;
   (b) 1 % churn of phase 3's 1M index (10,000 ids deleted with repair,
   10,000 rows of the corpus's mixture in one ``insert_batch``), the
   delete, insert and compact
   timed, the touched rows, repair blocks and offer rounds (and their
   seconds) printed with the
   launches of ``prune_sweep``, ``expand_score`` and ``beam_merge`` over
   the delete and insert (counted from 0), then QPS, iterations and
   recall@10 of the 10,000 mixed queries against ``brute_force`` over the
   live rows; tripwires: mean recall@10 ≥ 0.02, no deleted id surfaces,
   capacity unchanged; (c) 1,000 rows inserted into phase 3's index
   re-encoded as int8 + rerank and as pq + rerank: ``cuda`` equals
   ``torch`` bitwise;
8. serving at full width on phase 3's index (which phase 7's functional
   updates left as it was): (a) ``ServeEngine.retrieve_mixed`` of phase 3's
   10,000 mixed queries, padded to the 10,240 bucket, bitwise phase 3's
   ``search_mixed`` (ids, distances, steps, iterations), the attached
   store's buffers kept, its launches printed; then, outside every count,
   the padded and the unpadded batch timed in turns, and the QPS of the
   same requests as sync batches of 256 and through a
   runtime whose queue holds them all before its threads start; (b) the
   threaded ``ServeRuntime`` (micro-batches of up to 256) answering the
   same 10,000 queries as single-row requests with deadlines from a
   closed-loop client that keeps 512 requests in flight, a remove of 1,000
   live ids with repair and an upsert of 1,000 rows of the corpus's
   mixture submitted halfway: every reply bitwise a direct padded
   ``search_mixed`` on the snapshot it pinned, no removed document (a
   removed id still holding its old row; the upsert reuses the freed
   slots) and no dead slot in a reply after the write, nothing rejected,
   two writes, every tensor of the pre-write index unchanged; QPS, p50/p99
   over every reply's latency, the replies answered before the write and
   each write's seconds from its submission to its future's resolution
   printed; (c) ``bench_serve``
   (4,096 requests, micro-batches of 256) and ``bench_updates`` (1 %
   churn) on phase 3's corpus and index, their rows printed, the consistency
   rows at 1.000; (d) ``save_index`` → ``restore_index`` of (b)'s mutated
   index under ``build/`` (removed afterwards): every store tensor bitwise
   and a search of the 10,000 queries bitwise the live index's, save and
   restore seconds and bytes and the free disk space printed, and
   ``AsyncCheckpointer`` writing the same files; (e) the serve path's
   launches (the runtime's run (b), counted from 0): ``expand_score``,
   ``beam_merge`` and ``prune_sweep`` each above 0.
9. the row-sharded index (``core/sharded.py``) on the card, one process
   holding ``N_SHARDS`` shards, with a one-process NCCL group so that the
   NCCL collectives are called (a failure to start NCCL fails the phase):
   (a) ``build_sharded_store`` of phase 3's corpus with phase 3's
   ``UGConfig``, its seconds split into the ring bootstrap, the attribute
   candidates and the refinement, edges, columns, bytes and ``prune_sweep``
   launches; (b) the mixed sharded search of phase 3's 10,000 queries, QPS
   beside phase 3's and recall@10 per semantics against phase 3's exact
   truth (tripwire: mean ≥ 0.02); (c) checks: the sharded answer is bitwise
   the stable merge of the ``make_shard_probe_fns`` answers; on phase 4's
   50,000-row corpus (exact-KNN config) the build and search through the
   kernels equal the plain versions on the card bitwise, f32 and int8 +
   rerank; the device build's recall per semantics is at least the host
   build's (``build_sharded_index_host`` + ``shard_index``) minus 0.01; the
   ring KNN's neighbour sets of sampled rows are ``brute_force_knn``'s (up
   to ties at the k-th distance within f32 rounding); (d) ``SHARD_PROCS``
   spawned processes in a gloo group share the card, each holding
   ``N_SHARDS / SHARD_PROCS`` shards of (c)'s f32 index: their build, ring
   and search equal (c)'s one-process results bitwise; (e)
   ``FleetServeMonitor.probe`` over (a)'s probe functions, per-shard seconds
   and the report's plan; (f) the launches of ``SHARD_KERNELS`` over (a) and
   (b), each above 0.
10. the legacy A/B backends and the rest of the bench: (a) phase 3's
   10,000 mixed queries through the one-node-per-step ``legacy`` loop at
   ef = 64, QPS, iterations and recall@10 per semantics beside phase 3's
   fused numbers; on 50,000 integer-valued rows (columns spanning
   [-127, 127], so int8 dequantizes exactly) the legacy search on the card
   equals the same search of the same index on the CPU bitwise, on the f32
   plane and on int8 + rerank with 5 % of the rows tombstoned; (b)
   ``bench_build`` at the reference's sizes (1,000, 2,000 and 4,000 rows,
   d = 24): the ``legacy``, ``torch`` and ``cuda`` sweeps build graphs with
   equal checksums, the legacy sweep's profiled peak bytes beside the
   fused sweeps', and the sharded pq build; (c) ``bench_beam_sweep``,
   ``bench_mixed_workload`` and ``bench_memory`` on phase 3's index and
   queries, ``bench_scalability`` at 10,000, 100,000 and phase 3's
   1,000,000 rows (d = 128), ``bench_sensitivity`` at the reference's 2,000
   rows, their rows printed, and the launches of (a)'s check, (b) and (c),
   each kernel of ``LEGACY_BENCH_KERNELS`` above 0; (d) ``python -m
   repro_torch.bench.run --smoke --check`` against the baseline the CPU
   wrote, in a subprocess on the card: it must exit 0, and every recall that
   differs from the CPU's is printed with both values.

Before the last lines the script checks that no process it started (the
compiler, the spawned ranks, multiprocessing's resource tracker) is still
running.  The last line is ``{"ok": true, "device": {...}}``.  Nothing here imports
JAX or the reference package.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
N_MAIN = 1_000_000             # corpus rows of the main path (SIFT1M's size)
N_CHECK = 50_000               # corpus rows of the build-parity check
N_QUERIES = 10_000
PER_SEM = 1_000                # queries per semantics that recall is scored on
SEARCH = dict(ef=64, k=10, width=4)
WIDE_EFS = (128, 256, 1024)    # wider beams over the same queries
TIMED_BATCHES = 5
PQ_M = 16                      # pq subspaces at d = 128 (default_pq_m)
# The kernels each path launches; phase 3 runs the f32 path, phase 5 the rest.
PATH_KERNELS = {
    "f32": ("prune_sweep", "expand_score", "beam_merge"),
    "bf16": ("expand_score_bf16", "beam_merge"),
    "int8": ("expand_score_q", "expand_score", "beam_merge"),
    "pq": ("expand_score_pq", "expand_score", "beam_merge"),
}
PLANES = (("bf16", False), ("int8", True), ("pq", True))   # (tag, rerank)
PATH_KERNELS["bench"] = ("pairwise_sq_dist", "filtered_topk")  # phase 6
N_L2 = 65_536                  # corpus rows of the pairwise matrix (all 1M rows: 40 GB out)
N_PLAIN = 1_000                # queries the plain filtered_topk is checked and timed on
K_SCAN = 10
N_EXACT = 1_000                # rows of the build_exact check
N_CHURN_50K = 5_000            # phase 7(a): 10 % of phase 4's 50,000 rows
N_CHURN_1M = 10_000            # phase 7(b): 1 % of phase 3's 1M rows
N_QUANT_INSERT = 1_000         # phase 7(c): rows inserted into the int8 and pq indexes
UPDATE_KERNELS = ("prune_sweep", "expand_score", "beam_merge")   # phase 7's path
N_SERVE_WRITE = 1_000          # phase 8(b): ids removed and rows upserted mid-stream
SERVE_MAX_BATCH = 256          # phase 8(b): the runtime's micro-batch cap
SERVE_IN_FLIGHT = 512          # phase 8(b): the closed-loop client's requests in flight
SERVE_BENCH = dict(nreq=4_096, batch=256)                        # phase 8(c)
SERVE_KERNELS = ("expand_score", "beam_merge", "prune_sweep")    # phase 8's path
N_SHARDS = 4                   # phase 9: shards of the sharded index, all held by one process
SHARD_KERNELS = ("prune_sweep", "expand_score", "beam_merge")    # phase 9's path
SHARD_PROCS = 2                # phase 9(d): processes sharing the card, 2 shards each
SHARD_RING_K = 10              # phase 9(c), (d): neighbours of the ring KNN
SHARD_RING_SAMPLE = 1_000      # phase 9(c): rows whose ring neighbours are checked
N_LEGACY_CHECK = 50_000        # phase 10(a): rows of the legacy card == CPU check
N_LEGACY_CHECK_QUERIES = 1_000
LEGACY_TIMED = 2               # phase 10(a): timed legacy batches at 1M (after one warm-up)
SCALE_SIZES = (10_000, 100_000, N_MAIN)                            # phase 10(c)
# phase 10's paths: (c)'s fused search rows, planes and builds, (a)'s rerank
LEGACY_BENCH_KERNELS = ("expand_score", "expand_score_bf16", "expand_score_q",
                        "expand_score_pq", "beam_merge", "prune_sweep")
SMOKE_GATE_TIMEOUT = 400       # phase 10(d): seconds the bench gate's subprocess may take
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_FP32_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
PEAK_TF32_PER_S = 495e12       # H100 SXM TF32 on the tensor cores, dense
PEAK_BF16_PER_S = 989e12       # H100 SXM bf16 on the tensor cores, dense
N_L2_INT = (1_000, 8_192)      # queries x corpus rows of the integer-data bitwise check
KERNELS = {
    "expand_score": ("src/repro_torch/kernels/csrc/expand_score.cu",
                     "src/repro/kernels/expand_score.py:63"),
    "expand_score_bf16": ("src/repro_torch/kernels/csrc/expand_score.cu",
                          "src/repro/kernels/expand_score.py:63"),
    "expand_score_q": ("src/repro_torch/kernels/csrc/expand_score_q.cu",
                       "src/repro/kernels/expand_score.py:110"),
    "expand_score_pq": ("src/repro_torch/kernels/csrc/expand_score_pq.cu",
                        "src/repro/kernels/expand_score.py:250"),
    "beam_merge": ("src/repro_torch/kernels/csrc/beam_merge.cu",
                   "src/repro/kernels/beam_merge.py:132"),
    "prune_sweep": ("src/repro_torch/kernels/csrc/prune_sweep.cu",
                    "src/repro/kernels/prune_sweep.py:167"),
    "pairwise_sq_dist": ("src/repro_torch/kernels/csrc/l2dist.cu",
                         "src/repro/kernels/l2dist.py:49"),
    "filtered_topk": ("src/repro_torch/kernels/csrc/fused_scan.cu",
                      "src/repro/kernels/fused_scan.py:87"),
}

# How each kernel is held to its plain version: bitwise, or (the tensor-core
# products of pairwise_sq_dist and filtered_topk, 3xTF32) within a stated
# rule, and bitwise on small-integer data.
CHECKED = {name: dict(bitwise=True) for name in KERNELS}
CHECKED["pairwise_sq_dist"] = dict(
    bitwise=False, bitwise_on_integer_data=True,
    tolerance="|kernel - plain| <= (d + 4) * 2^-23 * (|q|^2 + |x|^2) elementwise")
CHECKED["filtered_topk"] = dict(
    bitwise=False, bitwise_on_integer_data=True,
    tolerance="with tol_i = (d + 4) * 2^-23 * (|q_i|^2 + max_j |x_j|^2): the +inf pattern "
              "equal; sorted values within tol_i; ids distinct, passing the predicate, "
              "their plain distances within tol_i of their values and at most the plain "
              "k-th value + 2 tol_i (fused_scan.rule_violations)")


# further keys a kernel's row carries into the kernels line where it has them
EXTRA_KEYS = ("bound_simt_ms", "bound_simt_by", "bf16_ms", "bf16_bound_ms", "bf16_bound_by")


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def children_left() -> list[str]:
    """This process's child processes that still exist, as ``"pid command"``."""
    me = str(os.getpid())
    left = []
    for proc in pathlib.Path("/proc").glob("[0-9]*"):
        try:
            stat = (proc / "stat").read_text()
            cmd = (proc / "cmdline").read_bytes().replace(b"\0", b" ").decode(errors="replace")
        except OSError:     # it ended while we looked
            continue
        if stat.rsplit(")", 1)[1].split()[1] == me:     # the field after the state is the parent
            left.append(f"{proc.name} {cmd.strip()}")
    return left


def bits_equal(a, b) -> bool:
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def max_abs_err(a, b) -> float:
    import torch

    a, b = a.double(), b.double()
    diff = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
    return float(diff.max()) if diff.numel() else 0.0


def cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean milliseconds per call over ``reps`` back-to-back calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float, peak: float = PEAK_FP32_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def l2dist_within_bound(got, want, q, x, what: str) -> dict:
    """Check ``|kernel − plain| ≤ (d + 4)·2⁻²³·(‖q‖² + ‖x‖²)`` elementwise
    (``l2dist.tolerance``, the stated bound of the tensor-core product), a
    block of query rows at a time with the norms folded once; returns the
    bound's factor, the largest ``|kernel − plain| / (‖q‖² + ‖x‖²)`` and the
    largest ``|kernel − plain|``."""
    from repro_torch.kernels.l2dist import tolerance_terms

    factor, qn, xn = tolerance_terms(q, x)
    qn, xn = qn.double(), xn.double()
    worst, worst_abs = 0.0, 0.0
    for r in range(0, got.shape[0], 1000):
        err = (got[r : r + 1000].double() - want[r : r + 1000].double()).abs()
        norms = qn[r : r + 1000, None] + xn[None, :]
        check(bool((err <= factor * norms).all()),
              f"{what}: kernel outside (d + 4)·2^-23·(|q|² + |x|²) of its plain version")
        worst = max(worst, float((err / norms.clamp_min(1e-30)).max()))
        worst_abs = max(worst_abs, float(err.max()))
    return dict(factor=factor, max_err_over_norms=worst, max_abs_err=worst_abs)


# ----------------------------------------------------------------- phases
def phase0_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from repro_torch.kernels.util import no_tf32

    no_tf32()
    emit(phase=0, card=smi, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    return smi


def phase1_build():
    from repro_torch.kernels import cuda_lib

    t0 = time.perf_counter()
    cuda_lib.lib()
    info = cuda_lib.build_info
    ptxas = [ln.strip() for ln in info.get("log", "").splitlines()
             if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
    emit(phase=1, build_seconds=info.get("seconds", 0.0), cached=info.get("cached"),
         load_seconds=time.perf_counter() - t0, ptxas=ptxas)


def phase2_kernels(dev) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.beam_merge import PAD_PAYLOAD

    rows = {}
    g = torch.Generator(device=dev).manual_seed(1234)

    # expand_score: n = 1M, d = 128, B = 10,000, C = 256, 20 % masked
    n, d, B, C = 1_000_000, 128, 10_000, 256
    x = torch.randn(n, d, generator=g, device=dev)
    q = torch.randn(B, d, generator=g, device=dev)
    idx = torch.randint(0, n, (B, C), generator=g, device=dev, dtype=torch.int32)
    idx = torch.where(torch.rand(B, C, generator=g, device=dev) < 0.2, -1, idx).contiguous()
    got = ops.expand_score(x, idx, q, backend="cuda")
    want = ops.expand_score(x, idx, q, backend="torch")
    torch.cuda.synchronize()
    check(bits_equal(got, want), "expand_score kernel != plain version")
    n_valid = int((idx >= 0).sum())
    b_ms, b_by = bound(n_valid * 4 * d + B * C * 8 + B * d * 4, n_valid * 3 * d)
    shape = dict(n=n, d=d, B=B, C=C, masked=B * C - n_valid)
    rows["expand_score"] = dict(
        ms=cuda_ms(lambda: ops.expand_score(x, idx, q, backend="cuda")),
        plain_ms=cuda_ms(lambda: ops.expand_score(x, idx, q, backend="torch"), reps=5),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=max_abs_err(got, want),
        shape=shape)

    # the same candidates on the bf16, int8 and pq planes of the same rows
    from repro_torch.core.store import VectorPlane
    from repro_torch.kernels.expand_score import pq_lut

    io_bytes = B * C * 8 + B * d * 4                      # ids in, distances out, queries
    planes = {
        "expand_score_bf16": (VectorPlane.encode(x, "bf16"), 2 * d, 3 * d),
        "expand_score_q": (VectorPlane.encode(x, "int8"), d, 5 * d),
        "expand_score_pq": (VectorPlane(
            "pq", torch.randint(0, 256, (n, PQ_M), generator=g, device=dev, dtype=torch.uint8),
            codebooks=torch.randn(PQ_M, 256, d // PQ_M, generator=g, device=dev)), PQ_M, PQ_M),
    }
    del x
    lut = pq_lut(planes["expand_score_pq"][0].codebooks, q)
    lut_ms = cuda_ms(lambda: pq_lut(planes["expand_score_pq"][0].codebooks, q), reps=5)
    for name, (plane, row_bytes, row_ops) in planes.items():
        run = lambda b: ops.expand_score_plane(plane, idx, q, backend=b, lut=lut)
        got, want = run("cuda"), run("torch")
        torch.cuda.synchronize()
        check(bits_equal(got, want), f"{name} kernel != plain version")
        # pq reads the (B, m, 256) tables in place of the queries
        extra = B * PQ_M * 256 * 4 - B * d * 4 if plane.tag == "pq" else 0
        extra += 2 * d * 4 if plane.tag == "int8" else 0       # scale and zero
        b_ms, b_by = bound(n_valid * row_bytes + io_bytes + extra, n_valid * row_ops)
        rows[name] = dict(
            ms=cuda_ms(lambda: run("cuda")), plain_ms=cuda_ms(lambda: run("torch"), reps=5),
            library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=max_abs_err(got, want),
            shape=dict(shape, m=PQ_M) if plane.tag == "pq" else shape)
    emit(phase=2, pq_lut_ms=lut_ms, pq_lut_shape=dict(B=B, m=PQ_M, K=256, dsub=d // PQ_M))
    del planes, lut, q, idx, got, want

    # beam_merge: B = 10,000, E = 64, L = 256, with ties, +inf and pads
    B, E, L = 10_000, 64, 256
    pool = torch.tensor([0.25, 0.5, 1.0, 2.0, float("inf")], device=dev)
    bd = pool[torch.randint(0, 5, (B, E), generator=g, device=dev)]
    bp = torch.randint(0, 500_000, (B, E), generator=g, device=dev, dtype=torch.int32) << 1
    bp = torch.where(torch.isfinite(bd), bp, PAD_PAYLOAD)
    bd, o = torch.sort(bd, dim=-1, stable=True)
    bp = torch.gather(bp, -1, o).contiguous()
    bd = bd.contiguous()
    cd = pool[torch.randint(0, 5, (B, L), generator=g, device=dev)].contiguous()
    cp = (torch.randint(0, 500_000, (B, L), generator=g, device=dev, dtype=torch.int32) << 1)
    cp = torch.where(torch.isfinite(cd), cp, PAD_PAYLOAD).contiguous()
    got = ops.beam_merge(bd, bp, cd, cp, backend="cuda")
    want = ops.beam_merge(bd, bp, cd, cp, backend="torch")
    torch.cuda.synchronize()
    check(all(bits_equal(a, b) for a, b in zip(got, want)), "beam_merge kernel != plain version")
    cat_d = torch.cat([bd, cd], dim=1)
    lg = int(np.log2(L))
    ce_per_row = L // 2 * lg * (lg + 1) // 2 + E + E // 2 * int(np.log2(E))
    b_ms, b_by = bound(B * (2 * E + 2 * L) * 4 + B * 2 * E * 4, B * ce_per_row * 2)
    rows["beam_merge"] = dict(
        ms=cuda_ms(lambda: ops.beam_merge(bd, bp, cd, cp, backend="cuda")),
        plain_ms=cuda_ms(lambda: ops.beam_merge(bd, bp, cd, cp, backend="torch"), reps=5),
        library_ms=cuda_ms(lambda: torch.topk(cat_d, E, dim=1, largest=False, sorted=True)),
        bound_ms=b_ms, bound_by=b_by,
        max_abs_err=max(max_abs_err(a, b) for a, b in zip(got, want)),
        shape=dict(B=B, E=E, L=L))
    # the same beams against L = 2048 candidates (the paper's degree 256 + 256
    # at W = 4: several warps a row), bitwise, timed beside its bound
    L = 2048
    cd = pool[torch.randint(0, 5, (B, L), generator=g, device=dev)].contiguous()
    cp = (torch.randint(0, 500_000, (B, L), generator=g, device=dev, dtype=torch.int32) << 1)
    cp = torch.where(torch.isfinite(cd), cp, PAD_PAYLOAD).contiguous()
    got = ops.beam_merge(bd, bp, cd, cp, backend="cuda")
    want = ops.beam_merge(bd, bp, cd, cp, backend="torch")
    torch.cuda.synchronize()
    check(all(bits_equal(a, b) for a, b in zip(got, want)),
          "beam_merge kernel != plain version at L = 2048")
    lg = int(np.log2(L))
    ce_per_row = L // 2 * lg * (lg + 1) // 2 + E + E // 2 * int(np.log2(E))
    b_ms, b_by = bound(B * (2 * E + 2 * L) * 4 + B * 2 * E * 4, B * ce_per_row * 2)
    rows["beam_merge"]["paper_degree"] = dict(
        ms=cuda_ms(lambda: ops.beam_merge(bd, bp, cd, cp, backend="cuda")),
        bound_ms=b_ms, bound_by=b_by, bitwise=True, shape=dict(B=B, E=E, L=L))
    del bd, bp, cd, cp, cat_d, got, want

    # prune_sweep: B = 1024, C = 96, d = 128, point intervals, all-pad rows
    B, C, d = 1024, 96, 128
    xs = torch.randn(B, C, d, generator=g, device=dev)
    i_c = torch.sort(torch.rand(B, C, 2, generator=g, device=dev), dim=-1).values
    i_c[::7, :, 1] = i_c[::7, :, 0]                         # point intervals
    i_u = torch.sort(torch.rand(B, 2, generator=g, device=dev), dim=-1).values
    i_u[::13, 1] = i_u[::13, 0]
    d_uc = torch.sort(torch.rand(B, C, generator=g, device=dev) * 2 * d, dim=-1).values
    valid = torch.rand(B, C, generator=g, device=dev) >= 0.1
    valid[::50] = False                                     # all-pad rows
    d_uc = torch.where(valid, d_uc, torch.inf)
    overlap = (torch.maximum(i_u[:, None, 0], i_c[..., 0])
               <= torch.minimum(i_u[:, None, 1], i_c[..., 1]))
    args = [t.contiguous() for t in (i_u, xs, i_c, d_uc, valid.int(), overlap.int())]
    kw = dict(m_if=32, m_is=32, alpha=1.0, unified=True)
    got = ops.prune_sweep(*args, backend="cuda", **kw)
    want = ops.prune_sweep(*args, backend="torch", **kw)
    torch.cuda.synchronize()
    check(all(bits_equal(a, b) for a, b in zip(got, want)), "prune_sweep kernel != plain version")
    # the pairs (t, w) the scan needs: valid t against retained w < t
    kept = (got[0] > 0).int()
    before = torch.cumsum(kept, dim=1) - kept
    pairs = int((before * valid.int()).sum())
    b_ms, b_by = bound(B * (2 + C * d + 2 * C + C + 2 * C) * 4 + 3 * B * C * 4, pairs * 3 * d)
    rows["prune_sweep"] = dict(
        ms=cuda_ms(lambda: ops.prune_sweep(*args, backend="cuda", **kw)),
        plain_ms=cuda_ms(lambda: ops.prune_sweep(*args, backend="torch", **kw), reps=3, warm=1),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        max_abs_err=max(max_abs_err(a, b) for a, b in zip(got, want)),
        shape=dict(B=B, C=C, d=d, pairs=pairs))
    for name, r in rows.items():
        emit(kernel=name, **CHECKED[name], kernel_ms=r["ms"], plain_ms=r["plain_ms"],
             library_ms=r["library_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
             shape=r["shape"], **{k: r[k] for k in ("paper_degree",) if k in r})
    return rows


def mixed_workload(ccfg, nq: int, dev):
    """10,000-style mixed batch: semantics cycling IF/IS/RS/RF; RS rows get
    point windows at the centre of their uniform window."""
    import torch

    from repro_torch.core import Semantics
    from repro_torch.data import make_queries

    cycle = [Semantics.IF, Semantics.IS, Semantics.RS, Semantics.RF]
    qv, wide = make_queries(ccfg, nq, workload="uniform", device=dev)
    _, point = make_queries(ccfg, nq, workload="point", device=dev)
    sems = [cycle[i % 4] for i in range(nq)]
    is_rs = torch.tensor([s is Semantics.RS for s in sems], device=dev)
    qi = torch.where(is_rs[:, None], point, wide)
    return qv, qi, sems


def scored_queries(idx, qv, qi, sems) -> dict:
    """The first ``PER_SEM`` queries of each semantics and their exact top 10."""
    import torch

    out = {}
    for s in sorted(set(sems), key=lambda s: s.value):
        sel = torch.tensor([i for i, ss in enumerate(sems) if ss is s][:PER_SEM], device=qv.device)
        out[s] = (sel, idx.ground_truth(qv[sel], qi[sel], sem=s, k=10))
    return out


def recall_per_semantics(res, scored) -> dict:
    """recall@10 per semantics of ``res`` over the queries of ``scored``."""
    from repro_torch.core import recall

    return {s.value: recall(subset(res, sel), truth) for s, (sel, truth) in scored.items()}


def mean(values) -> float:
    values = list(values)
    return sum(values) / len(values)


def subset(res, sel):
    from repro_torch.core import SearchResult

    return SearchResult(res.ids[sel], res.dist[sel], res.steps[sel])


def same_result(a, b) -> bool:
    return (bits_equal(a.ids, b.ids) and bits_equal(a.dist, b.dist)
            and bits_equal(a.steps, b.steps))


def phase3_main_path(dev):
    import statistics

    import torch

    from repro_torch.core import UGConfig, UGIndex
    from repro_torch.data import CorpusConfig, make_corpus
    from repro_torch.kernels import ops

    n, nq = N_MAIN, N_QUERIES
    ccfg = CorpusConfig(n=n, dim=128, seed=0)
    cfg = UGConfig(ef_spatial=32, ef_attribute=64, max_edges_if=32, max_edges_is=32,
                   iterations=3, exact_spatial=n <= 8192)
    torch.cuda.reset_peak_memory_stats()
    x, ints = make_corpus(ccfg, device=dev)
    qv, qi, sems = mixed_workload(ccfg, nq, dev)
    torch.cuda.synchronize()

    marks = {}

    def progress(msg):
        if msg.startswith("candidates"):
            torch.cuda.synchronize()
            marks["candidates"] = time.perf_counter()

    ops.reset_launches()                                   # the main path's run
    t_build = time.perf_counter()
    idx = UGIndex.build(x, ints, cfg, seed=0, device=dev, progress=progress)
    idx.search_mixed(qv, qi, sems, **SEARCH)                # warm-up
    seconds = []
    for _ in range(TIMED_BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = idx.search_mixed(qv, qi, sems, **SEARCH)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    launches = dict(ops.launches)

    scored = scored_queries(idx, qv, qi, sems)
    recalls = recall_per_semantics(res, scored)
    # the same scored queries through wider beams: recall that climbs with
    # ef says the graph leads to the true neighbours, only slowly
    sel = torch.cat([s for s, _ in scored.values()])
    pos = torch.empty(nq, dtype=torch.long, device=dev)
    pos[sel] = torch.arange(len(sel), device=dev)
    narrowed = {s: (pos[s_sel], truth) for s, (s_sel, truth) in scored.items()}
    sems_sel = [sems[i] for i in sel.tolist()]
    by_ef = {}
    for ef in WIDE_EFS:
        r = idx.search_mixed(qv[sel], qi[sel], sems_sel, ef=ef, k=10, width=4)
        by_ef[ef] = dict(recall_at_10=recall_per_semantics(r, narrowed), iters=r.iters,
                         mean_steps=float(r.steps.float().mean()))
    # queries drawn around corpus rows, with the corpus's own cluster spread
    g = torch.Generator(device=dev).manual_seed(7)
    rows = torch.randint(0, n, (nq,), generator=g, device=dev)
    qv_in = x[rows] + ccfg.cluster_std * torch.randn(nq, 128, generator=g, device=dev)
    res_in = idx.search_mixed(qv_in, qi, sems, **SEARCH)
    scored_in = scored_queries(idx, qv_in, qi, sems)
    recalls_in = recall_per_semantics(res_in, scored_in)
    mem = idx.vector_memory_bytes()
    med = statistics.median(seconds)
    emit(phase=3, n=n, d=128, queries=nq, build_seconds=idx.build_seconds,
         candidates_seconds=marks["candidates"] - t_build,
         degree_stats=idx.degree_stats(), graph_width=idx.graph.max_degree,
         graph_bytes=idx.memory_bytes(), plane_bytes=mem["plane"],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         search_seconds=seconds, qps=nq / med, qps_min=nq / max(seconds),
         qps_max=nq / min(seconds), iters=res.iters,
         mean_steps=float(res.steps.float().mean()), recall_at_10=recalls,
         recall_at_10_wider_beams=by_ef,
         recall_at_10_corpus_queries=recalls_in, iters_corpus_queries=res_in.iters,
         launches=launches)
    return dict(idx=idx, queries=(qv, qi, sems), scored=scored, recalls=recalls, qps=nq / med,
                launches=launches, qv_in=qv_in, scored_in=scored_in, res=res)


def search_checks(idx, queries, dev, what: str) -> None:
    """On the first 1,000 queries: the kernel path equals the plain path
    bitwise, and the mixed batch equals four per-semantics batches."""
    import torch

    qv, qi, sems = queries
    sub = slice(0, 1000)
    r_cuda = idx.search_mixed(qv[sub], qi[sub], sems[sub], backend="cuda", **SEARCH)
    r_torch = idx.search_mixed(qv[sub], qi[sub], sems[sub], backend="torch", **SEARCH)
    check(same_result(r_cuda, r_torch) and r_cuda.iters == r_torch.iters,
          f"{what} search: backend='cuda' != backend='torch'")
    for s in set(sems[sub]):
        sel = [i for i, ss in enumerate(sems[sub]) if ss is s]
        one = idx.search(qv[sel], qi[sel], sem=s, **SEARCH)
        check(same_result(subset(r_cuda, torch.tensor(sel, device=dev)), one),
              f"{what}: mixed batch != per-semantics batch for {s.value}")


def phase4_checks(dev, main):
    import torch

    from repro_torch.core import UGConfig, UGIndex
    from repro_torch.data import CorpusConfig, make_corpus

    launches = main["launches"]
    out = {}
    # (a) every kernel of the f32 path ran on it
    for name in PATH_KERNELS["f32"]:
        check(launches.get(name, 0) > 0, f"{name} was not launched on the main path")
    out["a_launches"] = launches

    # (b) kernel path == plain path and (c) the mixed batch equals four
    # per-semantics batches, on 1,000 queries
    search_checks(main["idx"], main["queries"], dev, "f32")
    out["b_search_bitwise"] = True
    out["c_mixed_equals_per_semantics"] = True

    # (d) a 50,000-row build: prune_backend cuda == torch
    ccfg = CorpusConfig(n=N_CHECK, dim=128, seed=1)
    x, ints = make_corpus(ccfg, device=dev)
    base = dict(ef_spatial=32, ef_attribute=64, max_edges_if=32, max_edges_is=32, iterations=3)
    idx50 = UGIndex.build(x, ints, UGConfig(**base, prune_backend="cuda"), device=dev)
    g_torch = UGIndex.build(x, ints, UGConfig(**base, prune_backend="torch"), device=dev).graph
    check(bits_equal(idx50.graph.nbrs, g_torch.nbrs)
          and bits_equal(idx50.graph.status, g_torch.status),
          "build: prune_backend='cuda' != 'torch'")
    out["d_build_bitwise"] = True

    # (e) tripwires: a broken graph or kernel gives recall near 0.  The
    # workload's query centres lie apart from the corpus's, and recall at
    # ef = 64 falls with n, so the 0.2 bar is held at 50,000 rows.  Beside
    # it, an exact-KNN build of the same corpus: NN-descent's share of the
    # recall lost.
    qv50, qi50, sems50 = mixed_workload(ccfg, 4 * PER_SEM, dev)
    scored50 = scored_queries(idx50, qv50, qi50, sems50)
    recalls50 = recall_per_semantics(idx50.search_mixed(qv50, qi50, sems50, **SEARCH), scored50)
    exact50 = UGIndex.build(x, ints, UGConfig(**base, exact_spatial=True), device=dev)
    recalls_exact = recall_per_semantics(
        exact50.search_mixed(qv50, qi50, sems50, **SEARCH), scored50)
    out["e_recall_at_10_50k"] = recalls50
    out["e_recall_at_10_50k_exact_spatial"] = recalls_exact
    out["e_degree_stats_50k"] = idx50.degree_stats()
    out["e_degree_stats_50k_exact_spatial"] = exact50.degree_stats()
    out["e_mean_recall_50k"] = mean50 = mean(recalls50.values())
    out["e_mean_recall_50k_exact_spatial"] = mean(recalls_exact.values())
    out["e_mean_recall_main"] = mean_main = mean(main["recalls"].values())
    check(mean50 >= 0.2, f"mean recall@10 {mean50} < 0.2 at n = {N_CHECK}")
    check(mean_main >= 0.02, f"mean recall@10 {mean_main} < 0.02 on the main path")
    emit(phase=4, **out)
    return dict(idx=idx50, queries=(qv50, qi50, sems50), scored=scored50, mean=mean50)


def phase5_planes(dev, main, check50) -> dict:
    """The quantized path on phase 3's graph; returns each plane's launches."""
    import statistics

    import torch

    from repro_torch.core.store import train_pq_codebooks
    from repro_torch.kernels import ops

    idx = main["idx"]
    qv, qi, sems = main["queries"]
    nq = qv.shape[0]
    path_launches = {}
    for tag, rerank in PLANES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx_t = idx.with_dtype(tag, rerank=rerank)
        torch.cuda.synchronize()
        encode_seconds = time.perf_counter() - t0
        extra = {}
        if tag == "pq":                                   # training alone, once more
            t0 = time.perf_counter()
            train_pq_codebooks(idx.x)
            torch.cuda.synchronize()
            extra["pq_train_seconds"] = time.perf_counter() - t0

        ops.reset_launches()                              # this plane's path
        idx_t.search_mixed(qv, qi, sems, **SEARCH)          # warm-up
        seconds = []
        for _ in range(TIMED_BATCHES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = idx_t.search_mixed(qv, qi, sems, **SEARCH)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        launches = dict(ops.launches)
        for name in PATH_KERNELS[tag]:
            check(launches[name] > 0, f"{name} was not launched on the {tag} path")
        path_launches[tag] = launches

        recalls = recall_per_semantics(res, main["scored"])
        res_in = idx_t.search_mixed(main["qv_in"], qi, sems, **SEARCH)
        recalls_in = recall_per_semantics(res_in, main["scored_in"])
        search_checks(idx_t, main["queries"], dev, tag)

        idx50 = check50["idx"].with_dtype(tag, rerank=rerank)
        qv50, qi50, sems50 = check50["queries"]
        recalls50 = recall_per_semantics(
            idx50.search_mixed(qv50, qi50, sems50, **SEARCH), check50["scored"])
        mean50 = mean(recalls50.values())
        check(mean50 >= 0.5 * check50["mean"],
              f"{tag}: mean recall@10 {mean50} < half of f32's {check50['mean']} at n = {N_CHECK}")

        mem = idx_t.vector_memory_bytes()
        med = statistics.median(seconds)
        emit(phase=5, plane=tag, rerank=rerank, n=idx_t.n, d=idx_t.store.dim,
             plane_bytes=mem["plane"], rerank_bytes=mem["rerank"],
             plane_bytes_per_vector=mem["plane_bytes_per_vector"],
             encode_seconds=encode_seconds, **extra, queries=nq,
             search_seconds=seconds, qps=nq / med, qps_min=nq / max(seconds),
             qps_max=nq / min(seconds), iters=res.iters,
             mean_steps=float(res.steps.float().mean()), recall_at_10=recalls,
             mean_recall_at_10=mean(recalls.values()),
             recall_at_10_corpus_queries=recalls_in,
             recall_at_10_50k=recalls50, mean_recall_at_10_50k=mean50,
             mean_recall_at_10_50k_f32=check50["mean"], launches=launches,
             checks=dict(search_bitwise=True, mixed_equals_per_semantics=True))
        del idx_t, idx50
    return path_launches


def same_topk(a, b) -> bool:
    return all(bits_equal(x, y) for x, y in zip(a, b))


def phase6_bench(dev, main) -> tuple[dict, dict]:
    """The bench path; returns the two scan kernels' rows and the path's
    launches."""
    import torch

    from repro_torch.bench import common, tables
    from repro_torch.core import Semantics
    from repro_torch.core import intervals as iv
    from repro_torch.core.baselines import prefilter_search
    from repro_torch.core.exact import build_exact
    from repro_torch.core.search import brute_force
    from repro_torch.data import CorpusConfig, make_queries
    from repro_torch.kernels import ops

    idx = main["idx"]
    x, ints = idx.x, idx.intervals
    n, d = x.shape
    ccfg = CorpusConfig(n=n, dim=d, seed=0)
    qv, qi = make_queries(ccfg, N_QUERIES, workload="uniform", device=dev)
    nq = qv.shape[0]
    rows = {}

    # (a) pairwise_sq_dist, f32 and bf16, within the stated bound; bitwise
    # on integer-valued data
    xl = x[:N_L2]
    nx = xl.shape[0]
    ratio = {}
    for tag, (qa, xa) in (("f32", (qv, xl)), ("bf16", (qv.to(torch.bfloat16), xl.to(torch.bfloat16)))):
        got = ops.pairwise_sq_dist(qa, xa, backend="cuda")
        want = ops.pairwise_sq_dist(qa, xa, backend="torch")
        torch.cuda.synchronize()
        ratio[tag] = l2dist_within_bound(got, want, qa, xa, f"pairwise_sq_dist ({tag})")
        del got, want
    gi = torch.Generator(device=dev).manual_seed(77)
    qi8, xi8 = (torch.randint(-8, 9, (m, d), generator=gi, device=dev).float() for m in N_L2_INT)
    for dt in (torch.float32, torch.bfloat16):
        got = ops.pairwise_sq_dist(qi8.to(dt), xi8.to(dt), backend="cuda")
        want = ops.pairwise_sq_dist(qi8.to(dt), xi8.to(dt), backend="torch")
        torch.cuda.synchronize()
        check(bits_equal(got, want), f"pairwise_sq_dist kernel != plain version on integer data ({dt})")
    del got, want, qi8, xi8
    emit(phase=6, pairwise_sq_dist_max_err_over_norms={
             t: r["max_err_over_norms"] for t, r in ratio.items()},
         bound_over_norms=ratio["f32"]["factor"], integer_bitwise=dict(shape=N_L2_INT + (d,)))
    qb, xb = qv.to(torch.bfloat16), xl.to(torch.bfloat16)
    # bound_ms is the tightest the card allows an fp32-accurate product:
    # 3xTF32 on the tensor cores; the fp32 SIMT bound is kept beside it
    simt_ms, simt_by = bound((nq + nx) * d * 4 + nq * nx * 4, 2 * nq * nx * d + 3 * nq * nx)
    tc_ms, tc_by = bound((nq + nx) * d * 4 + nq * nx * 4, 3 * 2 * nq * nx * d, PEAK_TF32_PER_S)
    bf_ms, bf_by = bound((nq + nx) * d * 2 + nq * nx * 4, 2 * nq * nx * d, PEAK_BF16_PER_S)
    rows["pairwise_sq_dist"] = dict(
        bf16_ms=cuda_ms(lambda: ops.pairwise_sq_dist(qb, xb, backend="cuda"), reps=10),
        library_ms=cuda_ms(lambda: torch.cdist(qv, xl), reps=10),
        library="torch.cdist (adds a square root)", bound_ms=tc_ms, bound_by=tc_by,
        bound_simt_ms=simt_ms, bound_simt_by=simt_by,
        bf16_bound_ms=bf_ms, bf16_bound_by=bf_by,
        max_abs_err=max(r["max_abs_err"] for r in ratio.values()),
        max_err_over_norms={t: r["max_err_over_norms"] for t, r in ratio.items()},
        shape=dict(nq=nq, nx=nx, d=d))
    del qb, xb

    # (b) filtered_topk: within its rule on 1,000 queries against the whole
    # corpus and at a ragged small shape; bitwise on integer-valued data
    from repro_torch.kernels.fused_scan import rule_violations

    qs, qis = qv[:N_PLAIN], qi[:N_PLAIN]
    scan, err = {}, 0.0
    for is_filter in (True, False):
        kw = dict(is_filter=is_filter, k=K_SCAN)
        got = ops.filtered_topk(qs, x, ints, qis, backend="cuda", **kw)
        want = ops.filtered_topk(qs, x, ints, qis, backend="torch", **kw)
        torch.cuda.synchronize()
        broken = rule_violations(qs, x, ints, qis, got=got, want=want, is_filter=is_filter)
        check(not broken, f"filtered_topk outside its rule (is_filter={is_filter}): {broken}")
        err = max(err, max_abs_err(got[0], want[0]))
        small = (qv[:77], x[:3001], ints[:3001], qi[:77])
        for k in (1, 64):
            got_s = ops.filtered_topk(*small, is_filter=is_filter, k=k, backend="cuda")
            want_s = ops.filtered_topk(*small, is_filter=is_filter, k=k, backend="torch")
            broken = rule_violations(*small, got=got_s, want=want_s, is_filter=is_filter)
            check(not broken, f"filtered_topk outside its rule at 77 x 3001, k = {k}: {broken}")
        scan[is_filter] = got
    qi8, xi8 = (torch.randint(-8, 9, (m, d), generator=gi, device=dev).float()
                for m in (N_PLAIN, N_L2))
    for dt in (torch.float32, torch.bfloat16):
        for is_filter in (True, False):
            case = (qi8.to(dt), xi8.to(dt), ints[:N_L2], qis)
            kw = dict(is_filter=is_filter, k=K_SCAN)
            check(same_topk(ops.filtered_topk(*case, backend="cuda", **kw),
                            ops.filtered_topk(*case, backend="torch", **kw)),
                  f"filtered_topk kernel != plain version on integer data ({dt}, {is_filter})")
    del qi8, xi8
    emit(phase=6, filtered_topk_within_rule=dict(queries=N_PLAIN, nx=n, small=[77, 3001, [1, 64]]),
         filtered_topk_max_abs_err=err, integer_bitwise=dict(shape=[N_PLAIN, N_L2, d]))
    # bound_ms: the 3xTF32 product on the tensor cores; the fp32 SIMT bound
    # and the bf16 entry's beside it
    io = (nq + n) * 2 * 4 + nq * K_SCAN * 8                 # intervals in, top-k out
    tc_ms, tc_by = bound((nq + n) * d * 4 + io, 3 * 2 * nq * n * d, PEAK_TF32_PER_S)
    simt_ms, simt_by = bound((nq + n) * d * 4 + io, 2 * nq * n * d)
    bf_ms, bf_by = bound((nq + n) * d * 2 + io, 2 * nq * n * d, PEAK_BF16_PER_S)
    qb, xb = qv.to(torch.bfloat16), x.to(torch.bfloat16)
    rows["filtered_topk"] = dict(
        plain_queries=N_PLAIN, library_ms=None,
        brute_force_ms=cuda_ms(lambda: brute_force(x, ints, qv, qi, sem=Semantics.IF, k=K_SCAN),
                               reps=1, warm=1),
        bf16_ms=cuda_ms(lambda: ops.filtered_topk(qb, xb, ints, qi, is_filter=True, k=K_SCAN,
                                                  backend="cuda"), reps=3, warm=1),
        bound_ms=tc_ms, bound_by=tc_by, bound_simt_ms=simt_ms, bound_simt_by=simt_by,
        bf16_bound_ms=bf_ms, bf16_bound_by=bf_by, max_abs_err=err,
        shape=dict(nq=nq, nx=n, d=d, k=K_SCAN))
    del qb, xb

    # (c) the scan is the exact pre-filter
    prefilter = {}
    for is_filter, sem in ((True, Semantics.IF), (False, Semantics.IS)):
        vals, ids = scan[is_filter]
        truth = prefilter_search(x, ints, qs, qis, sem=sem, k=K_SCAN)
        finite = torch.isfinite(truth.dist)
        check(bool(torch.equal(finite, torch.isfinite(vals))), f"{sem.value}: +inf pattern differs")
        hits = sum(len(set(a[a >= 0].tolist()) & set(b[b >= 0].tolist()))
                   for a, b in zip(ids.cpu().numpy(), truth.ids.cpu().numpy()))
        overlap = hits / max(int(finite.sum()), 1)
        close = bool(torch.allclose(vals[finite], truth.dist[finite], rtol=1e-5, atol=0.0))
        differ = int((ids != truth.ids).any(dim=1).sum())
        prefilter[sem.value] = dict(id_overlap=overlap, values_allclose=close, rows_differ=differ)
        check(overlap >= 0.999 and close, f"filtered_topk vs prefilter_search ({sem.value}): "
              f"overlap {overlap}, allclose {close}")
    del scan
    emit(phase=6, prefilter_cross_check=prefilter)

    # (d) Exp-1, Exp-4 and the kernel table through the bench entry point, on
    # phase 3's index; the kernel table's rows are the two kernels' times
    b = common.Bench(n=n, dim=d, nq=nq, device=dev, cfg=idx.config, corpus=(x, ints), ug=idx)
    ops.reset_launches()                                   # the bench path's run
    bench_rows = tables.bench_ifann(b) + tables.bench_indexing(b) + tables.bench_kernels(
        data=(qv, x, ints, qi), l2_nx=N_L2, plain_nq=N_PLAIN, device=dev)
    launches = dict(ops.launches)
    for r in bench_rows:
        emit(phase=6, row=r["name"], us_per_call=r["us_per_call"], derived=r["derived"],
             **r["metrics"])
    for name in PATH_KERNELS["bench"]:
        check(launches[name] > 0, f"{name} was not launched on the bench path")
    by_name = {r["name"]: r["metrics"] for r in bench_rows}
    for name, row in (("pairwise_sq_dist", "kernel_l2dist"), ("filtered_topk", "kernel_fusedscan")):
        rows[name].update(ms=1e3 * by_name[f"{row}_cuda"]["seconds"],
                          plain_ms=1e3 * by_name[f"{row}_torch_plain"]["seconds"])
        emit(phase=6, kernel=name, **CHECKED[name], **{k: v for k, v in rows[name].items()
                                                       if k != "max_abs_err"})
    check(by_name["ifann_prefilter_exact"]["recall"] == 1.0, "pre-filter recall != 1")
    pf, hp = b.postfilter_index(), b.hipng_index()
    for what, res in (("post-filter", pf.search(qv, qi, sem=Semantics.IF, ef=128, k=10,
                                                oversample=8)),
                      ("Hi-PNG", hp.search(qv, qi, ef=64, k=10))):
        ok = iv.predicate(Semantics.IF, ints[res.ids.clamp(min=0).long()], qi[:, None, :])
        check(bool((ok | (res.ids < 0)).all()), f"{what} returned an id outside its window")
    sub = slice(0, 1000)
    r_cuda = pf.search(qv[sub], qi[sub], sem=Semantics.IF, ef=128, k=10, oversample=8,
                       backend="cuda")
    r_torch = pf.search(qv[sub], qi[sub], sem=Semantics.IF, ef=128, k=10, oversample=8,
                        backend="torch")
    check(same_result(r_cuda, r_torch), "post-filter search: backend='cuda' != 'torch'")

    # (e) build_exact at n = 1,000: prune backends agree; heredity (Thm 3.5)
    xe, ie = x[:N_EXACT], ints[:N_EXACT]
    t0 = time.perf_counter()
    g = build_exact(xe, ie, backend="cuda", device=dev)
    torch.cuda.synchronize()
    exact_cuda_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    g_torch = build_exact(xe, ie, backend="torch", device=dev)
    torch.cuda.synchronize()
    exact_torch_s = time.perf_counter() - t0
    check(bits_equal(g.nbrs, g_torch.nbrs) and bits_equal(g.status, g_torch.status),
          "build_exact: prune backend cuda != torch")
    mask = iv.query_valid_mask(Semantics.IF, ie, torch.tensor([0.25, 0.75], device=dev))
    rebuilt = build_exact(xe, ie, node_mask=mask, backend="cuda", device=dev)

    def if_edges(graph):
        nb, st = graph.nbrs.cpu().numpy(), graph.status.cpu().numpy()
        return {(u, int(v)) for u in range(nb.shape[0]) for v, f in zip(nb[u], st[u])
                if v >= 0 and f & Semantics.IF.flag}
    check(if_edges(g.induced(mask)) == if_edges(rebuilt), "build_exact: heredity (Thm 3.5) fails")
    emit(phase=6, launches=launches, tripwires=dict(
             filtered_answers_pass_predicate=True, prefilter_recall=1.0,
             postfilter_search_bitwise=True),
         build_exact=dict(n=N_EXACT, d=d, seconds_cuda=exact_cuda_s, seconds_torch=exact_torch_s,
                          max_degree=g.max_degree, edges=int((g.nbrs >= 0).sum()),
                          valid_nodes_of_heredity_window=int(mask.sum()), bitwise=True,
                          heredity=True))
    return rows, launches


def same_store(a, b) -> bool:
    """Every array of two indexes' stores equal bit for bit."""
    sa, sb = a.store, b.store
    if (sa.rerank is None) != (sb.rerank is None):
        return False
    pairs = [(sa.nbrs, sb.nbrs), (sa.status, sb.status), (sa.intervals, sb.intervals),
             (sa.alive, sb.alive), (sa.free, sb.free), (sa.plane.data, sb.plane.data)]
    if sa.rerank is not None:
        pairs.append((sa.rerank.data, sb.rerank.data))
    return all(bits_equal(x, y) for x, y in pairs)


def surfaced(res, ids) -> bool:
    """Whether any of ``ids`` is among the answers of ``res``."""
    import torch

    return bool(torch.isin(res.ids[res.ids >= 0], ids).any())


def timed(fn):
    """``(result, seconds)`` of ``fn()`` with the card synchronised around it."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def more_rows(n: int, seed: int, extra: int, dev):
    """``extra`` new rows from the mixture of ``make_corpus(n, seed)``: a
    longer draw with the same seed (the cluster centres come first in its
    stream), its rows past ``n``."""
    from repro_torch.data import CorpusConfig, make_corpus

    x, ints = make_corpus(CorpusConfig(n=n + extra, dim=128, seed=seed), device=dev)
    return x[n:].contiguous(), ints[n:].contiguous()


def churn_recalls(m, queries, dev) -> tuple[dict, dict, float]:
    """recall@10 per semantics of a churned index and of a fresh build of
    its live set (same config), and the fresh build's seconds."""
    import torch

    from repro_torch.core import UGIndex

    qv, qi, sems = queries
    recalls = recall_per_semantics(m.search_mixed(qv, qi, sems, **SEARCH),
                                   scored_queries(m, qv, qi, sems))
    live = torch.nonzero(m.alive).flatten()
    fresh, seconds = timed(lambda: UGIndex.build(m.x[live], m.intervals[live], m.config,
                                                 device=dev))
    fresh_recalls = recall_per_semantics(fresh.search_mixed(qv, qi, sems, **SEARCH),
                                         scored_queries(fresh, qv, qi, sems))
    return recalls, fresh_recalls, seconds


def phase7_updates(dev, main, check50, smi) -> dict:
    """Streaming updates on the kernels; returns the update path's launches."""
    import statistics

    import torch

    from repro_torch.core import updates
    from repro_torch.data import CorpusConfig, make_corpus
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(70)

    # (a) 10 % churn of the 50,000-row index, kernels against plain versions
    idx50 = check50["idx"]
    qv50, qi50, sems50 = check50["queries"]
    dels = torch.randperm(idx50.n, generator=g, device=dev)[:N_CHURN_50K].to(torch.int32)
    new_x, new_iv = more_rows(N_CHECK, 1, N_CHURN_50K, dev)
    out, secs = {}, {}
    for backend in ("cuda", "torch"):
        stats = {}
        d, secs[f"delete_{backend}"] = timed(
            lambda: idx50.delete(dels, backend=backend, stats=stats))
        m, secs[f"insert_{backend}"] = timed(lambda: d.insert(
            new_x, new_iv, backend=backend, search_backend=backend, stats=stats))
        out[backend] = (d, m)
    bitwise = [same_store(a, b) for a, b in zip(out["cuda"], out["torch"])]
    d, m = out["cuda"]
    del out
    slots_reused = m.capacity == idx50.capacity and m.n == idx50.n
    hidden = not surfaced(d.search_mixed(qv50, qi50, sems50, **SEARCH), dels)
    res = m.search_mixed(qv50, qi50, sems50, **SEARCH)
    live_only = bool(m.alive[res.ids[res.ids >= 0].long()].all())
    recalls, fresh_recalls, fresh_s = churn_recalls(m, check50["queries"], dev)
    comp = m.compact()
    live = torch.nonzero(m.alive).flatten()
    remap = torch.full((m.capacity,), -1, dtype=torch.long, device=dev)
    remap[live] = torch.arange(live.numel(), device=dev)
    res_c = comp.search_mixed(qv50, qi50, sems50, **SEARCH)
    mapped = torch.where(res.ids >= 0, remap[res.ids.clamp(min=0).long()], -1)
    same_sets = all(set(a[a >= 0].tolist()) == set(b[b >= 0].tolist())
                    for a, b in zip(mapped.cpu(), res_c.ids.cpu()))
    # the same churn with rows from new cluster centres: measured only
    shifted_x, shifted_iv = make_corpus(CorpusConfig(n=N_CHURN_50K, dim=128, seed=71),
                                        device=dev)
    shifted = churn_recalls(d.insert(shifted_x, shifted_iv), check50["queries"], dev)
    emit(phase=7, part="a", card=smi, n=idx50.n, deleted=N_CHURN_50K, inserted=N_CHURN_50K,
         seconds=secs, touched_rows=stats["touched_rows"], repair_blocks=stats["repair_blocks"],
         offer_rounds=stats["offer_rounds"], capacity=m.capacity,
         recall_at_10=recalls, recall_at_10_fresh_build=fresh_recalls,
         fresh_build_seconds=fresh_s,
         other_seed_rows=dict(recall_at_10=shifted[0], recall_at_10_fresh_build=shifted[1]),
         checks=dict(cuda_equals_torch_after_delete=bitwise[0],
                     cuda_equals_torch_after_insert=bitwise[1], deleted_never_surface=hidden,
                     dead_slots_never_surface=live_only, slots_reused=slots_reused,
                     compact_same_answer_sets=same_sets))
    for step, ok in zip(("delete", "insert"), bitwise):
        check(ok, f"7a: {step}: backend='cuda' != 'torch'")
    check(slots_reused, "7a: capacity or live count moved")
    check(hidden and live_only, "7a: a deleted id or a dead slot surfaced")
    for s, r in recalls.items():
        check(r >= fresh_recalls[s] - 0.02,
              f"7a: {s} recall@10 {r} below the fresh build's {fresh_recalls[s]} - 0.02")
    check(same_sets, "7a: compact() changed an answer set")
    del d, m, comp, res, res_c

    # (b) 1 % churn of the 1M index on the kernels, timed
    idx = main["idx"]
    qv, qi, sems = main["queries"]
    nq = qv.shape[0]
    dels = torch.randperm(idx.n, generator=g, device=dev)[:N_CHURN_1M].to(torch.int32)
    new_x, new_iv = more_rows(N_MAIN, 0, N_CHURN_1M, dev)
    ops.reset_launches()                                   # the update path's run
    stats = {}
    d, delete_s = timed(lambda: idx.delete(dels, stats=stats))
    # the insert's reverse-offer rounds timed inside it, the card synchronised
    # around them
    rounds, offer_rounds = {}, updates._offer_rounds

    def timed_rounds(*args, **kw):
        n, rounds["seconds"] = timed(lambda: offer_rounds(*args, **kw))
        return n

    updates._offer_rounds = timed_rounds
    try:
        m, insert_s = timed(lambda: d.insert(new_x, new_iv, stats=stats))
    finally:
        updates._offer_rounds = offer_rounds
    launches = dict(ops.launches)
    for name in UPDATE_KERNELS:
        check(launches.get(name, 0) > 0, f"{name} was not launched on the update path")
    check(m.capacity == idx.capacity and m.n == idx.n, "7b: capacity or live count moved")
    check(not surfaced(d.search_mixed(qv, qi, sems, **SEARCH), dels),
          "7b: a deleted id surfaced")
    m.search_mixed(qv, qi, sems, **SEARCH)                   # warm-up
    seconds = []
    for _ in range(TIMED_BATCHES):
        res, t = timed(lambda: m.search_mixed(qv, qi, sems, **SEARCH))
        seconds.append(t)
    check(bool(m.alive[res.ids[res.ids >= 0].long()].all()), "7b: a dead slot surfaced")
    recalls = recall_per_semantics(res, scored_queries(m, qv, qi, sems))
    mean_recall = mean(recalls.values())
    check(mean_recall >= 0.02, f"7b: mean recall@10 {mean_recall} < 0.02 after churn")
    _, compact_s = timed(lambda: m.compact())
    med = statistics.median(seconds)
    emit(phase=7, part="b", card=smi, n=idx.n, d=128, deleted=N_CHURN_1M, inserted=N_CHURN_1M,
         delete_repair_seconds=delete_s, insert_seconds=insert_s, compact_seconds=compact_s,
         touched_rows=stats["touched_rows"], repair_blocks=stats["repair_blocks"],
         offer_rounds=stats["offer_rounds"], offer_rounds_seconds=rounds["seconds"],
         launches=launches, queries=nq, search_seconds=seconds, qps=nq / med, iters=res.iters,
         mean_steps=float(res.steps.float().mean()), recall_at_10=recalls,
         mean_recall_at_10=mean_recall, mean_recall_at_10_before=mean(main["recalls"].values()),
         capacity=m.capacity, checks=dict(deleted_never_surface=True, slots_reused=True))
    del d, m, res

    # (c) inserts into the int8 + rerank and pq + rerank indexes
    new_x, new_iv = make_corpus(CorpusConfig(n=N_QUANT_INSERT, dim=128, seed=73), device=dev)
    quant = {}
    for tag in ("int8", "pq"):
        idx_t = idx.with_dtype(tag, rerank=True)
        got, cuda_s = timed(lambda: idx_t.insert(new_x, new_iv, backend="cuda",
                                                 search_backend="cuda"))
        want, torch_s = timed(lambda: idx_t.insert(new_x, new_iv, backend="torch",
                                                   search_backend="torch"))
        check(same_store(got, want), f"7c: {tag} insert: backend='cuda' != 'torch'")
        quant[tag] = dict(seconds_cuda=cuda_s, seconds_torch=torch_s, capacity=got.capacity,
                          n=got.n, bitwise=True)
        del idx_t, got, want
    emit(phase=7, part="c", card=smi, inserted=N_QUANT_INSERT, planes=quant)
    return launches


def store_tensors(store) -> dict:
    """Every tensor of a store by name, the entry structure's included."""
    named = dict(plane=store.plane.data, intervals=store.intervals, nbrs=store.nbrs,
                 status=store.status, alive=store.alive, free=store.free,
                 scale=store.plane.scale, zero=store.plane.zero,
                 codebooks=store.plane.codebooks,
                 rerank=None if store.rerank is None else store.rerank.data)
    named.update({f"entry_{i}": a for i, a in enumerate(store.entry.arrays())})
    return {k: v for k, v in named.items() if v is not None}


def phase8_serve(dev, main, smi) -> dict:
    """Serving on phase 3's index; returns the serve path's launches (the
    runtime's run, (b))."""
    import collections
    import filecmp
    import shutil

    import numpy as np
    import torch

    from repro_torch import ckpt
    from repro_torch.bench import common, tables
    from repro_torch.ckpt.store import index_tree
    from repro_torch.core import intervals as iv
    from repro_torch.kernels import ops
    from repro_torch.serve import RuntimeConfig, ServeEngine, ServeRuntime
    from repro_torch.serve.engine import bucket_batch_size
    from repro_torch.serve.runtime import count_pinned_matches

    idx = main["idx"]
    qv, qi, sems = main["queries"]
    nq = qv.shape[0]
    flags = iv.as_sem_flags(sems, nq, device=dev)
    ef_k = dict(ef=SEARCH["ef"], k=SEARCH["k"])
    ops.reset_launches()                                   # (a)'s run

    # (a) the engine: phase 3's batch through retrieve_mixed, padded
    eng = ServeEngine()
    eng.attach_index(idx, width=SEARCH["width"])
    ptrs = [t.data_ptr() for t in (idx.store.plane.data, idx.store.nbrs)]
    res, retrieve_s = timed(lambda: eng.retrieve_mixed(None, qi, sems, q_v=qv, **ef_k))
    launches_a = dict(ops.launches)
    ref = main["res"]
    check(same_result(res, ref) and res.iters == ref.iters,
          "8a: retrieve_mixed != phase 3's search_mixed")
    check(eng.index is idx and [t.data_ptr() for t in (eng.index.store.plane.data,
                                                       eng.index.store.nbrs)] == ptrs,
          "8a: attach_index copied the store")
    # outside every count: what the bucket padding costs (the padded and the
    # unpadded batch in turns), and where the runtime's time goes: the same requests
    # as sync batches of the micro-batch size through the engine (the search
    # alone), and through a runtime whose queue holds them all before its
    # threads start (no submitter beside the dispatcher)
    turns = dict(padded=lambda: eng.retrieve_mixed(None, qi, sems, q_v=qv, **ef_k),
                 unpadded=lambda: idx.search_mixed(qv, qi, sems, **SEARCH))
    pad_s = {name: [] for name in turns}
    for name in ("padded", "unpadded", "unpadded", "padded"):
        pad_s[name].append(timed(turns[name])[1])
    q_rows, w_rows = qv.cpu().numpy(), qi.cpu().numpy()     # requests arrive on the host
    mb = SERVE_MAX_BATCH
    _, batched_s = timed(lambda: [eng.retrieve_mixed(None, qi[s:s + mb], sems[s:s + mb],
                                                     q_v=qv[s:s + mb], **ef_k)
                                  for s in range(0, nq, mb)])
    queued = ServeRuntime(ServeEngine(index=idx), RuntimeConfig(max_batch=mb, max_queue=nq))
    futs = [queued.submit(q_rows[i], w_rows[i], sems[i], **ef_k) for i in range(nq)]
    t0 = time.perf_counter()
    with queued:
        for f in futs:
            f.result(timeout=600)
    prequeued_s = time.perf_counter() - t0
    emit(phase=8, part="a", card=smi, queries=nq, padded_to=bucket_batch_size(nq),
         seconds=retrieve_s, qps=nq / retrieve_s, iters=res.iters, launches=launches_a,
         padding_turns_seconds=pad_s, sync_batches_qps=nq / batched_s, prequeued_runtime_qps=nq / prequeued_s,
         checks=dict(bitwise_phase3=True, store_by_reference=True))

    # (b) the threaded runtime: single-row requests from a closed-loop
    # client, a write halfway
    before = {k: v.clone() for k, v in store_tensors(idx.store).items()}
    g = torch.Generator(device=dev).manual_seed(80)
    dels = torch.randperm(idx.n, generator=g, device=dev)[:N_SERVE_WRITE].to(torch.int32)
    dels_h = dels.cpu().numpy()
    new_x, new_iv = more_rows(N_MAIN, 0, N_SERVE_WRITE, dev)
    write_s = {}

    def submit_write(name, submit):
        """Submit a write; its seconds run from here to its future's resolution."""
        t_sub = time.perf_counter()
        fut = submit()
        fut.add_done_callback(
            lambda _: write_s.__setitem__(name, time.perf_counter() - t_sub))
        return fut

    ops.reset_launches()                                   # the serve path's run: (b)
    t0 = time.perf_counter()
    with ServeRuntime(eng, RuntimeConfig(max_batch=SERVE_MAX_BATCH)) as rt:
        futs, writes, window = [], [], collections.deque()
        for i in range(nq):
            if i == nq // 2:
                writes = [submit_write("remove", lambda: rt.submit_remove(dels_h)),
                          submit_write("upsert", lambda: rt.submit_upsert(new_x, new_iv))]
            if len(window) == SERVE_IN_FLIGHT:
                window.popleft().result(timeout=600)
            futs.append(rt.submit(q_rows[i], w_rows[i], sems[i],
                                  deadline=rt.clock() + 600.0, **ef_k))
            window.append(futs[-1])
        replies = [f.result(timeout=600) for f in futs]
        written = [w.result(timeout=60) for w in writes]
        stats = rt.stats()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    lats = np.asarray([r.latency_s for r in replies])
    p50_ms, p99_ms = 1e3 * np.percentile(lats, [50, 99], method="inverted_cdf")
    snapshots = len({id(r.index) for r in replies})
    pinned_ok = count_pinned_matches(replies, qv, qi, flags, **ef_k)
    pre = [r for r in replies if r.index is idx]
    mutated = eng.index
    post_ids = np.concatenate([r.ids for r in replies if r.index is not idx])
    post_ids = torch.as_tensor(post_ids[post_ids >= 0], device=dev).long()
    # the upsert takes the slots the remove freed: a removed id may answer
    # again, holding a new row; a removed document is its id with its old row
    reused = post_ids[torch.isin(post_ids, dels.long())]
    removed_surfaced = int((mutated.store.plane.data[reused]
                            == idx.store.plane.data[reused]).all(dim=1).sum())
    dead_surfaced = int((~mutated.alive[post_ids]).sum())
    after = store_tensors(idx.store)
    unchanged = after.keys() == before.keys() and all(bits_equal(after[k], v)
                                                      for k, v in before.items())
    emit(phase=8, part="b", card=smi, requests=nq, max_batch=SERVE_MAX_BATCH,
         in_flight=SERVE_IN_FLIGHT, qps=nq / wall, wall_seconds=wall, p50_ms=p50_ms,
         p99_ms=p99_ms, completed=stats["completed"], rejected=stats["rejected"],
         writes=stats["writes"], written=written, write_seconds=write_s,
         answered_pre_write=len(pre), snapshots=snapshots, replies_bitwise_pinned=pinned_ok,
         reused_ids_in_post_write_replies=int(reused.numel()),
         removed_documents_surfaced=removed_surfaced, dead_slots_surfaced=dead_surfaced,
         launches=launches, checks=dict(pre_write_index_unchanged=unchanged))
    check(pinned_ok == nq, f"8b: {nq - pinned_ok} replies differ from their pinned snapshot")
    check(removed_surfaced == 0 and dead_surfaced == 0,
          "8b: a removed document or a dead slot surfaced after the write")
    check(stats["rejected"] == 0 and stats["writes"] == 2 and stats["completed"] == nq
          and written == [N_SERVE_WRITE] * 2, f"8b: runtime counters off: {stats}, {written}")
    check(snapshots == 2 and 0 < len(pre) < nq, "8b: the write did not split the stream")
    check(unchanged, "8b: a write changed a tensor of the pre-write index")
    del before, after, replies, futs, eng

    # (c) the serve and updates tables on phase 3's corpus and index
    b = common.Bench(n=idx.capacity, dim=idx.store.dim, nq=nq, device=dev, cfg=idx.config,
                     corpus=(idx.x, idx.intervals), ug=idx)
    rows = tables.bench_serve(b, **SERVE_BENCH) + tables.bench_updates(b, churn=0.01)
    for r in rows:
        emit(phase=8, part="c", card=smi, row=r["name"], us_per_call=r["us_per_call"],
             derived=r["derived"], **r["metrics"])
    cons = {r["name"]: r["metrics"] for r in rows}["serve_consistency"]
    check(cons["recall_vs_pinned_snapshot"] == 1.0 and cons["recall_async_eq_sync"] == 1.0,
          f"8c: serve consistency {cons}")

    # (d) checkpoints of (b)'s mutated index
    root = ROOT / "build" / "ckpt_smoke"
    shutil.rmtree(root, ignore_errors=True)
    free_before = shutil.disk_usage(ROOT).free
    try:
        path, save_s = timed(lambda: ckpt.save_index(root / "sync", 0, mutated))
        nbytes = sum(f.stat().st_size for f in path.rglob("*") if f.is_file())
        back, restore_s = timed(lambda: ckpt.restore_index(root / "sync", device=dev))
        stores_equal = same_store(mutated, back)
        r_live = mutated.search_mixed(qv, qi, sems, **SEARCH)
        r_back = back.search_mixed(qv, qi, sems, **SEARCH)
        search_equal = same_result(r_live, r_back) and r_live.iters == r_back.iters
        saver = ckpt.AsyncCheckpointer(root / "async")
        arrays, extra = index_tree(mutated)
        t0 = time.perf_counter()
        saver.save(0, arrays, extra=extra)
        saver.wait()
        async_s = time.perf_counter() - t0
        files = sorted(f.name for f in (path / "arrays").iterdir())
        same_files = (files == sorted(f.name for f in (saver.last_path / "arrays").iterdir())
                      and all(filecmp.cmp(path / "arrays" / f, saver.last_path / "arrays" / f,
                                          shallow=False) for f in files))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit(phase=8, part="d", card=smi, n_live=mutated.n, capacity=mutated.capacity,
         free_disk_bytes_before=free_before, bytes=nbytes, files=files, save_seconds=save_s,
         restore_seconds=restore_s, async_save_seconds=async_s,
         checks=dict(stores_bitwise=stores_equal, search_bitwise=search_equal,
                     async_same_files=same_files))
    check(stores_equal, "8d: the restored store differs from the saved one")
    check(search_equal, "8d: search on the restored index differs")
    check(same_files, "8d: AsyncCheckpointer wrote other files than save_index")

    # (e) the serve path ran the kernels
    for name in SERVE_KERNELS:
        check(launches.get(name, 0) > 0, f"{name} was not launched on the serve path")
    emit(phase=8, part="e", launches=launches)
    return launches


def phase9_sharded(dev, main, check50, smi) -> dict:
    """The row-sharded index on the card; returns the sharded path's
    launches ((a) and (b))."""
    import dataclasses
    import datetime
    import statistics

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import SearchResult, UGConfig
    from repro_torch.core import intervals as iv
    from repro_torch.core.candidates import brute_force_knn
    from repro_torch.core.sharded import (
        build_sharded_index_host, build_sharded_store, make_ring_knn_fn, make_shard_probe_fns,
        make_sharded_search_fn, shard_index,
    )
    from repro_torch.distributed import ring_all_gather, ring_reduce_scatter
    from repro_torch.ft import StragglerConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharded import collective_inputs, rank_program, spawn_ranks
    from repro_torch.serve import FleetServeMonitor

    work = ROOT / "build" / "phase9"
    work.mkdir(parents=True, exist_ok=True)
    store_file = work / "nccl_store"
    store_file.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store_file}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        check(dist.get_backend() == "nccl", "phase 9: the process group is not NCCL")
        mesh = make_mesh((N_SHARDS,), ("data",), device=dev)
        idx = main["idx"]
        qv, qi, sems = main["queries"]
        nq = qv.shape[0]
        flags = iv.as_sem_flags(sems, nq, device=dev)
        x, ints = idx.x, idx.intervals

        # (a) the sharded build of phase 3's corpus with phase 3's config
        marks = {}

        def progress(msg):
            torch.cuda.synchronize()
            marks[msg.split(":")[0]] = time.perf_counter()

        ops.reset_launches()                                # (a) and (b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sidx = build_sharded_store(mesh, x, ints, idx.config, progress=progress)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        build_launches = dict(ops.launches)
        st = sidx.store
        nbytes = st.memory_bytes()["total"] + sidx.global_ids.numel() * 4
        emit(phase=9, part="a", card=smi, n=idx.n, d=int(x.shape[1]), shards=N_SHARDS,
             build_seconds=build_s, ring_seconds=marks["ring"] - t0,
             attribute_seconds=marks["attribute candidates"] - marks["ring"],
             refine_seconds=marks["refinement"] - marks["attribute candidates"],
             edges=int((st.nbrs >= 0).sum()), live_cols=int(st.nbrs.shape[1]), bytes=nbytes,
             prune_sweep_launches=build_launches["prune_sweep"],
             nccl=dict(backend=dist.get_backend(), world=dist.get_world_size()))

        # (b) the mixed sharded search of phase 3's queries
        fn = make_sharded_search_fn(mesh, mixed=True, **SEARCH)
        fn(sidx, qv, qi, flags)                             # warm-up
        seconds = []
        for _ in range(TIMED_BATCHES):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ids, dist_ = fn(sidx, qv, qi, flags)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t1)
        launches = dict(ops.launches)
        res = SearchResult(ids, dist_, torch.zeros(nq, dtype=torch.int32, device=dev))
        recalls = recall_per_semantics(res, main["scored"])
        mean9 = mean(recalls.values())
        check(mean9 >= 0.02, f"9b: mean recall@10 {mean9} < 0.02 on the sharded index")
        med = statistics.median(seconds)
        emit(phase=9, part="b", card=smi, queries=nq, search_seconds=seconds, qps=nq / med,
             qps_min=nq / max(seconds), qps_max=nq / min(seconds), qps_phase3=main["qps"],
             recall_at_10=recalls, mean_recall_at_10=mean9, recall_at_10_phase3=main["recalls"],
             launches=launches)

        # (c) the checks
        out = {}
        probe_fns = make_shard_probe_fns(sidx, N_SHARDS, **SEARCH)
        parts = [p(qv, qi, flags) for p in probe_fns]
        merged_d, order = torch.sort(torch.cat([p[1] for p in parts], 1), dim=1, stable=True)
        merged_i = torch.gather(torch.cat([p[0] for p in parts], 1), 1, order[:, :SEARCH["k"]])
        check(bits_equal(merged_i, ids) and bits_equal(merged_d[:, :SEARCH["k"]], dist_),
              "9c: the sharded answer != the stable merge of the probes' answers")
        out["sharded_equals_merged_probes"] = True

        x50, ints50 = check50["idx"].x, check50["idx"].intervals
        qv50, qi50, sems50 = check50["queries"]
        sub = slice(0, 1000)
        q50 = (qv50[sub], qi50[sub], iv.as_sem_flags(sems50[sub], len(sems50[sub]), device=dev))
        cfg50 = UGConfig(ef_spatial=32, ef_attribute=64, max_edges_if=32, max_edges_is=32,
                         iterations=3, exact_spatial=True)
        built, seconds50, launches50 = {}, {}, {}
        for dtype, rerank in (("f32", False), ("int8", True)):
            for backend in ("cuda", "torch"):
                before = dict(ops.launches)
                s50, seconds50[f"{dtype}_{backend}"] = timed(lambda: build_sharded_store(
                    mesh, x50, ints50, cfg50, dtype=dtype, rerank=rerank, backend=backend))
                f50 = make_sharded_search_fn(mesh, mixed=True, backend=backend, plane_tag=dtype,
                                             has_rerank=rerank, **SEARCH)
                built[dtype, backend] = (s50, f50(s50, *q50))
                if backend == "cuda":
                    launches50[dtype] = {k: v - before[k] for k, v in ops.launches.items()}
            (a, ra), (b, rb) = built[dtype, "cuda"], built[dtype, "torch"]
            tensors = lambda s: [s.store.nbrs, s.store.status, s.store.plane.data, s.global_ids]
            check(all(bits_equal(u, v) for u, v in zip(tensors(a), tensors(b)))
                  and all(bits_equal(u, v) for u, v in zip(ra, rb)),
                  f"9c: sharded {dtype} build or search: kernels != plain versions")
        out["build_and_search_cuda_equals_torch"] = dict(f32=True, int8_rerank=True,
                                                         seconds=seconds50, launches=launches50)

        dev50 = built["f32", "cuda"][0]
        host50, host_s = timed(lambda: shard_index(mesh, ("data",), *build_sharded_index_host(
            x50, ints50, N_SHARDS, cfg50, device=dev)))
        scored50 = check50["scored"]
        f50 = make_sharded_search_fn(mesh, mixed=True, **SEARCH)
        q_all = (qv50, qi50, iv.as_sem_flags(sems50, len(sems50), device=dev))
        steps0 = torch.zeros(len(sems50), dtype=torch.int32, device=dev)
        r_dev, r_host = (recall_per_semantics(SearchResult(*f50(sx, *q_all), steps0), scored50)
                         for sx in (dev50, host50))
        check(all(r_dev[s] >= r_host[s] - 0.01 for s in r_dev),
              f"9c: device build recall {r_dev} below the host build's {r_host} - 0.01")
        out["recall_device_build"], out["recall_host_build"] = r_dev, r_host
        out["host_build_seconds"] = host_s

        ring_ids, ring_d = make_ring_knn_fn(mesh, k=SHARD_RING_K)(dev50.store.plane.data,
                                                                  dev50.global_ids)
        truth = brute_force_knn(x50, SHARD_RING_K)
        g = torch.Generator(device=dev).manual_seed(90)
        rows = torch.randperm(ring_ids.shape[0], generator=g, device=dev)[:SHARD_RING_SAMPLE]
        exact, ties = 0, 0
        x64 = x50.double()
        gids_s = dev50.global_ids[rows]
        ring_s = ring_ids[rows].tolist()
        truth_s = truth.ids[gids_s.clamp_min(0).long()].tolist()
        for gid, ring_row, truth_row in zip(gids_s.tolist(), ring_s, truth_s):
            if gid < 0:
                continue
            a, b = set(ring_row), set(truth_row)
            if a == b:
                exact += 1
                continue
            d64 = ((x64 - x64[gid]) ** 2).sum(1)
            kth = float(d64[list(b)].max())
            off = [float(d64[v]) for v in a ^ b]
            check(all(abs(v - kth) <= 1e-5 * kth for v in off),
                  f"9c: ring KNN of global row {gid}: {sorted(a)} != {sorted(b)}")
            ties += 1
        out["ring_rows_checked"], out["ring_rows_exact"], out["ring_rows_tied"] = (
            exact + ties, exact, ties)
        emit(phase=9, part="c", card=smi, n=int(x50.shape[0]), **out)

        # (d) SHARD_PROCS processes share the card in a gloo group
        inputs = work / "inputs.npz"
        np.savez(inputs, x=x50.cpu().numpy(), intervals=ints50.cpu().numpy(),
                 qv=q50[0].cpu().numpy(), qi=q50[1].cpu().numpy(), flags=q50[2].cpu().numpy())
        ranks = work / "ranks"
        ranks.mkdir(exist_ok=True)
        params = dict(device=f"cuda:{torch.cuda.current_device()}", shards=N_SHARDS,
                      cfg=dataclasses.asdict(cfg50), ring_k=SHARD_RING_K, **SEARCH)
        gloo_file = work / "gloo_store"
        gloo_file.unlink(missing_ok=True)
        _, procs_s = timed(lambda: spawn_ranks(rank_program, SHARD_PROCS,
                                               (str(inputs), str(ranks), params),
                                               backend="gloo", init_file=gloo_file,
                                               timeout=300.0))
        got = [dict(np.load(ranks / f"rank{r}.npz")) for r in range(SHARD_PROCS)]
        ids50, dist50 = built["f32", "cuda"][1]
        blocks, chunks = collective_inputs(mesh, "data")
        one = dict(nbrs=dev50.store.nbrs, status=dev50.store.status, gids=dev50.global_ids,
                   ring_ids=ring_ids, ring_dist=ring_d,
                   all_gather=ring_all_gather(blocks, mesh, "data")[1],
                   reduce_scatter=ring_reduce_scatter(chunks, mesh, "data"))
        for key, want in one.items():
            have = torch.as_tensor(np.concatenate([r[key] for r in got]), device=dev)
            check(bits_equal(have, want), f"9d: {key} of {SHARD_PROCS} processes != one process's")
        for r in got:
            check(bits_equal(torch.as_tensor(r["ids"], device=dev), ids50)
                  and bits_equal(torch.as_tensor(r["dist"], device=dev), dist50),
                  f"9d: the search of {SHARD_PROCS} processes != one process's")
        emit(phase=9, part="d", card=smi, processes=SHARD_PROCS, backend="gloo",
             device=params["device"], seconds=procs_s,
             checks=dict(build_bitwise=True, ring_bitwise=True, collectives_bitwise=True,
                         search_bitwise=True))

        # (e) the fleet monitor over (a)'s probe functions
        fm = FleetServeMonitor(n_shards=N_SHARDS, n_devices=2 * N_SHARDS)
        probe_q = (qv[:1000], qi[:1000], flags[:1000])
        rounds = [fm.probe(probe_fns, *probe_q) for _ in range(StragglerConfig().warmup + 4)]
        rep = fm.report()
        emit(phase=9, part="e", card=smi, probe_queries=int(probe_q[0].shape[0]),
             per_shard_seconds=rounds[-1],
             stragglers=rep["stragglers"], recommendations=rep["recommendations"],
             plan=dataclasses.asdict(rep["plan"]),
             degraded_plan=None if rep["degraded_plan"] is None
             else dataclasses.asdict(rep["degraded_plan"]))
    finally:
        dist.destroy_process_group()

    # (f) the sharded path ran the kernels
    for name in SHARD_KERNELS:
        check(launches.get(name, 0) > 0, f"{name} was not launched on the sharded path")
    emit(phase=9, part="f", card=smi, launches=launches)
    return launches


def integer_corpus(n: int, seed: int, dev):
    """Integer-valued vectors whose columns span exactly [-127, 127] (an int8
    plane then dequantizes exactly: scale 1, zero 0), every distance exact
    in f32; the corpus's own intervals and a mixed batch of integer queries."""
    import torch

    from repro_torch.data import CorpusConfig, make_corpus

    ccfg = CorpusConfig(n=n, dim=128, seed=seed)
    x, ints = make_corpus(ccfg, device=dev)
    x = torch.clamp(torch.round(x * 40), -127, 127)
    x[0], x[1] = -127.0, 127.0
    qv, qi, sems = mixed_workload(ccfg, N_LEGACY_CHECK_QUERIES, dev)
    return x, ints, (torch.clamp(torch.round(qv * 40), -127, 127), qi, sems)


def on_cpu(index):
    """The same index on the CPU (the checkpoint arrays, the entry structure
    rebuilt there)."""
    from repro_torch.core.index import host_arrays, store_from_arrays

    return index.with_store(store_from_arrays(host_arrays(index.store), index.dtype, "cpu"))


def phase10_legacy_bench(dev, main, smi) -> dict:
    """The legacy A/B backends and the rest of the bench; returns the
    launches of phase 10's paths ((a)'s check, (b) and (c))."""
    import statistics

    import torch

    from repro_torch.bench import common, run, tables
    from repro_torch.core import UGConfig, UGIndex
    from repro_torch.data import CorpusConfig, make_queries
    from repro_torch.kernels import ops

    idx = main["idx"]
    qv, qi, sems = main["queries"]
    nq = qv.shape[0]

    # (a) the legacy loop on phase 3's index and queries, beside phase 3's
    idx.search_mixed(qv, qi, sems, backend="legacy", **SEARCH)        # warm-up
    seconds = []
    for _ in range(LEGACY_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = idx.search_mixed(qv, qi, sems, backend="legacy", **SEARCH)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    recalls = recall_per_semantics(res, main["scored"])
    check(mean(recalls.values()) >= 0.02, f"10a: legacy mean recall@10 {recalls} < 0.02")
    emit(phase=10, part="a", card=smi, n=idx.n, queries=nq, backend="legacy",
         search_seconds=seconds, qps=nq / statistics.median(seconds), iters=res.iters,
         mean_steps=float(res.steps.float().mean()), recall_at_10=recalls,
         fused=dict(qps=main["qps"], iters=main["res"].iters,
                    mean_steps=float(main["res"].steps.float().mean()),
                    recall_at_10=main["recalls"]))
    del res

    # the legacy search on the card is the same search on the CPU, on
    # integer data, on the f32 plane and on int8 + rerank with tombstones
    ops.reset_launches()                                   # phase 10's paths
    x50, ints50, (qv50, qi50, sems50) = integer_corpus(N_LEGACY_CHECK, 5, dev)
    cfg = UGConfig(ef_spatial=32, ef_attribute=64, max_edges_if=32, max_edges_is=32,
                   iterations=3)
    idx50 = UGIndex.build(x50, ints50, cfg, device=dev)
    dels = torch.randperm(N_LEGACY_CHECK, generator=torch.Generator().manual_seed(9))
    q50 = idx50.with_dtype("int8").delete(dels[: N_LEGACY_CHECK // 20].to(torch.int32),
                                           repair=False)
    check(bool((q50.store.plane.scale == 1).all() and (q50.store.plane.zero == 0).all()),
          "10a: the integer corpus does not dequantize exactly")
    cpu_q = (qv50.cpu(), qi50.cpu(), sems50)
    legacy_check = {}
    for tag, index in (("f32", idx50), ("int8_rerank_alive", q50)):
        t0 = time.perf_counter()
        card = index.search_mixed(qv50, qi50, sems50, backend="legacy", **SEARCH)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        host = on_cpu(index).search_mixed(*cpu_q, backend="legacy", **SEARCH)
        t_cpu = time.perf_counter() - t0
        check(same_result(result_on_cpu(card), host) and card.iters == host.iters,
              f"10a: the legacy search on the card != on the CPU ({tag})")
        legacy_check[tag] = dict(iters=card.iters, seconds_card=t_card, seconds_cpu=t_cpu)
    emit(phase=10, part="a", card=smi, n=N_LEGACY_CHECK, queries=N_LEGACY_CHECK_QUERIES,
         card_equals_cpu_bitwise=legacy_check)

    # (b) the build table at the reference's sizes: legacy, torch and cuda
    # sweeps with equal graph checksums (bench_build raises otherwise), the
    # sweeps' profiles at the build's block shape; the sharded build at 4,000
    bench_rows = {}

    def table(part, rows):
        for r in rows:
            bench_rows[r["name"]] = r
            emit(phase=10, part=part, row=r["name"], us_per_call=r["us_per_call"],
                 derived=r["derived"], **r["metrics"])

    table("b", tables.bench_build(common.BUILD_SIZES, device=dev))
    sweeps = tables.profile_backends(dev)                  # legacy, torch, cuda
    emit(phase=10, part="b", card=smi, sweeps=sweeps, sweep_peak_bytes={
        b: bench_rows[f"build_sweep_profile_{b}"]["metrics"]["peak_bytes"] for b in sweeps})

    # (c) the tables at full width on phase 3's corpus, index and queries
    ccfg = CorpusConfig(n=idx.n, dim=128, seed=0)
    batches = {w: make_queries(ccfg, nq, workload=w, device=dev) for w in ("uniform", "point")}
    b = common.Bench(n=idx.n, dim=128, nq=nq, device=dev, cfg=idx.config,
                     corpus=(idx.x, idx.intervals), ug=idx, queries=batches)
    table("c", tables.bench_beam_sweep(b))
    table("c", tables.bench_mixed_workload(b, require_speedup=2.0))
    table("c", tables.bench_memory(b, require_reduction=3.0))
    table("c", tables.bench_scalability(b, sizes=SCALE_SIZES))
    table("c", tables.bench_sensitivity(common.Bench(n=common.SENSITIVITY_N, device=dev)))
    launches = dict(ops.launches)
    for name in LEGACY_BENCH_KERNELS:
        check(launches.get(name, 0) > 0, f"{name} was not launched on phase 10's paths")
    emit(phase=10, part="c", card=smi, launches=launches)

    # (d) the bench gate: a smoke run on the card against the baseline the
    # CPU wrote; a recall that differs from the CPU's (floor + slack) is
    # printed with both values
    baseline = ROOT / "src" / "repro_torch" / "bench" / "baseline_smoke.json"
    out = ROOT / "build" / "phase10_smoke.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.run", "--smoke", "--check", str(baseline),
         "--json", str(out)], cwd=ROOT, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=SMOKE_GATE_TIMEOUT)
    gate_s = time.perf_counter() - t0
    floors = json.loads(baseline.read_text())["rows"]
    differ = {}
    for r in json.loads(out.read_text())["rows"] if out.exists() else []:
        got = run.parse_metrics(r["derived"])
        for key, floor in floors.get(r["name"], {}).get("min", {}).items():
            cpu = round(floor + run.RECALL_SLACK, 3)
            if key in got and abs(got[key] - cpu) > 5e-4:
                differ[f"{r['name']}:{key}"] = dict(card=got[key], cpu=cpu)
    regressions = [ln for ln in proc.stderr.splitlines() if "REGRESSION" in ln or "FAILED" in ln]
    emit(phase=10, part="d", card=smi, returncode=proc.returncode, seconds=gate_s,
         regressions=regressions, recall_differs_from_cpu=differ,
         gate=[ln for ln in proc.stderr.splitlines() if "perf gate" in ln])
    check(proc.returncode == 0, f"10d: the bench gate failed on the card: {regressions}\n"
                                f"{proc.stderr[-4000:]}")
    return launches


def result_on_cpu(res):
    """A card result's tensors on the CPU."""
    from repro_torch.core import SearchResult

    return SearchResult(res.ids.cpu(), res.dist.cpu(), res.steps.cpu(), res.iters)


def main() -> int:
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    smi = phase0_card()
    dev = torch.device("cuda")
    phase1_build()
    rows = phase2_kernels(dev)
    main_path = phase3_main_path(dev)
    check50 = phase4_checks(dev, main_path)
    path_launches = phase5_planes(dev, main_path, check50)
    path_launches["f32"] = main_path["launches"]
    scan_rows, path_launches["bench"] = phase6_bench(dev, main_path)
    rows.update(scan_rows)
    update_launches = phase7_updates(dev, main_path, check50, smi)
    serve_launches = phase8_serve(dev, main_path, smi)
    shard_launches = phase9_sharded(dev, main_path, check50, smi)
    legacy_launches = phase10_legacy_bench(dev, main_path, smi)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = rows[name]
        # each kernel's launches on its own path (phase 3 or phase 5)
        path = next(p for p in PATH_KERNELS if name in PATH_KERNELS[p])
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=path_launches[path][name], **CHECKED[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            **{k: r[k] for k in EXTRA_KEYS if k in r},
            **({"launches_updates": update_launches[name]} if name in UPDATE_KERNELS else {}),
            **({"launches_serve": serve_launches[name]} if name in SERVE_KERNELS else {}),
            **({"launches_sharded": shard_launches[name]} if name in SHARD_KERNELS else {}),
            **({"launches_legacy_bench": legacy_launches[name]}
               if name in LEGACY_BENCH_KERNELS else {})))
    left = children_left()
    check(not left, f"processes this run started are still running: {left}")
    emit(seconds=time.perf_counter() - t_start, card=smi, children_left=len(left))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
