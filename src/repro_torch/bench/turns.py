"""Time this tree's kernels on the search path and the scan against
another tree's, in turns, on one card, and profile one search batch.

    python -m repro_torch.bench.turns --baseline DIR [--trace FILE]

``DIR`` is the root of another tree of the repository (for example the
parent commit, unpacked with ``git archive``).  Its ``kernels/csrc`` is
built with this tree's ``cuda_lib.build`` under
``build/repro_torch_kernels/baseline``, and its ``filtered_topk`` gets the
corpus ranges its own ``fused_scan.splits_for`` picks.  Both builds'
``-Xptxas -v`` lines for these kernels are printed.  Each kernel runs in
the order baseline, this tree, this tree, baseline, each turn the mean of
CUDA-event timed back-to-back calls after a warm-up, and its answers are
checked first.  In order:

- ``scorers``: ``expand_score`` f32 and bf16, ``expand_score_q`` and
  ``expand_score_pq`` (m = 16) on the same candidates at the main path's
  shape (n = 1M, d = 128, B = 10,000, C = 256, 20 % masked), bitwise
  against the baseline's;
- ``filtered_topk``: 10,000 queries × 1M rows × 128, k = 10, IF and IS,
  f32 and bf16, within ``fused_scan.rule_violations`` of the baseline's;
- ``beam_merge``: B = 10,000, E = 64 at L = 256 (``chip_smoke.py`` phase
  2's draw) and at L = 2048 (the paper's degree 256 + 256, W = 4), bitwise
  against the baseline's;
- ``search``: builds ``chip_smoke.py``'s 1M index (its corpus, config and
  10,000 mixed queries at ef = 64, k = 10, W = 4), records the share of
  merged rows whose candidates are all pads at every iteration of one f32
  batch and the merge's inputs at iterations 1, 20 and 40, times
  ``beam_merge`` on those in turns (bitwise against the baseline's), then
  traces one more batch with ``torch.profiler`` and prints the device's
  idle share and each iteration's split between the scorer, the merge,
  the other kernels and the host's syncs (``--trace`` keeps the trace).

Prints one JSON object per line.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import pathlib
import subprocess
import tempfile
import time

import torch

from repro_torch.kernels import cuda_lib, fused_scan, ops
from repro_torch.kernels.beam_merge import PAD_PAYLOAD, next_pow2
from repro_torch.kernels.util import no_tf32

SHAPE_Q = dict(n=1_000_000, d=128, B=10_000, C=256)
PQ_M = 16                      # pq subspaces at d = 128
SHAPE_SCAN = dict(nq=10_000, nx=1_000_000, d=128, k=10)
MERGE_B, MERGE_E, MERGE_LS = 10_000, 64, (256, 2048)
SEARCH_N, SEARCH_NQ = 1_000_000, 10_000
SEARCH = dict(ef=64, k=10, width=4)
CAPTURE_ITERS = (1, 20, 40)    # merges of the loop's iterations (0 is the entry merge)
REPS_Q, REPS_SCAN = 20, 3      # calls a turn
KERNELS = pathlib.Path("src/repro_torch/kernels")


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


def ms_per_call(fn, reps: int, warm: int = 1) -> float:
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


def in_turns(old, new, reps: int) -> dict:
    """old, new, new, old; returns each turn and the two means."""
    t = [ms_per_call(f, reps) for f in (old, new, new, old)]
    return dict(turns_ms=t, baseline_ms=(t[0] + t[3]) / 2, ms=(t[1] + t[2]) / 2)


def ptxas(info: dict, sources: tuple[str, ...]) -> list[str]:
    out, keep = [], False
    for ln in info.get("log", "").splitlines():
        if ln.startswith("== "):
            keep = ln[3:].strip() in sources
        elif keep and ("Compiling entry" in ln or "Used" in ln or "spill" in ln):
            out.append(ln.strip())
    return out


def bitwise_turns(name: str, libs: dict, call, out_shape, dev, reps: int) -> dict:
    """``call(lib, out)`` launches one tree's kernel into ``out``.  Checks
    that this tree's output is the baseline's bit for bit, then times the
    two in turns."""
    outs = {tag: torch.empty(out_shape, device=dev) for tag in libs}
    for tag, lib in libs.items():
        cuda_lib.check(call(lib, outs[tag]), f"{name} ({tag})")
    torch.cuda.synchronize()
    if not torch.equal(outs["baseline"].view(torch.int32), outs["new"].view(torch.int32)):
        raise AssertionError(f"{name}: this tree's kernel != the baseline's")
    row = in_turns(lambda: call(libs["baseline"], outs["baseline"]),
                   lambda: call(libs["new"], outs["new"]), reps)
    return dict(row, bitwise_equal=True)


def scorer_rows(libs: dict, dev, reps: int):
    """The four scorers on the same candidates: int8, bf16, f32, pq."""
    n, d, B, C = SHAPE_Q.values()
    g = torch.Generator(device=dev).manual_seed(1234)
    x = torch.randint(-127, 128, (n, d), generator=g, device=dev, dtype=torch.int8)
    scale = torch.rand(d, generator=g, device=dev) * 0.1 + 0.01
    zero = torch.randn(d, generator=g, device=dev)
    q = torch.randn(B, d, generator=g, device=dev)
    idx = torch.randint(0, n, (B, C), generator=g, device=dev, dtype=torch.int32)
    idx = torch.where(torch.rand(B, C, generator=g, device=dev) < 0.2, -1, idx).contiguous()
    shape = dict(SHAPE_Q, masked=int((idx < 0).sum()))
    stream = cuda_lib.stream_ptr(q)
    p = lambda t: t.data_ptr()

    def q8(lib, out):
        return lib.repro_expand_score_q(p(x), p(scale), p(zero), p(idx), p(q), p(out),
                                        n, d, B, C, stream)

    yield dict(kernel="expand_score_q", **bitwise_turns("expand_score_q", libs, q8, (B, C),
                                                         dev, reps), shape=shape)
    del x
    xf = torch.randn(n, d, generator=g, device=dev)
    for name, xs in (("expand_score_bf16", xf.to(torch.bfloat16)), ("expand_score", xf)):
        def run(lib, out, name=name, xs=xs):
            return getattr(lib, "repro_" + name)(p(xs), p(idx), p(q), p(out), n, d, B, C, stream)

        yield dict(kernel=name, **bitwise_turns(name, libs, run, (B, C), dev, reps), shape=shape)
    del xf
    codes = torch.randint(0, 256, (n, PQ_M), generator=g, device=dev, dtype=torch.uint8)
    lut = torch.randn(B, PQ_M, 256, generator=g, device=dev)

    def pq(lib, out):
        return lib.repro_expand_score_pq(p(codes), p(lut), p(idx), p(out), n, PQ_M, B, C, stream)

    yield dict(kernel="expand_score_pq", **bitwise_turns("expand_score_pq", libs, pq, (B, C),
                                                          dev, reps), shape=dict(shape, m=PQ_M))


def baseline_splits_for(root: pathlib.Path):
    """The ``splits_for`` of the tree at ``root`` (its own rule for its own
    kernel's blocks)."""
    spec = importlib.util.spec_from_file_location("baseline_fused_scan",
                                                  root / KERNELS / "fused_scan.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.splits_for


def filtered_topk_rows(libs: dict, dev, reps: int, baseline_splits) -> list[dict]:
    nq, nx, d, k = SHAPE_SCAN.values()
    g = torch.Generator(device=dev).manual_seed(4321)
    x = torch.randn(nx, d, generator=g, device=dev)
    q = torch.randn(nq, d, generator=g, device=dev)
    oi = torch.sort(torch.rand(nx, 2, generator=g, device=dev), dim=1).values
    c = torch.rand(nq, 1, generator=g, device=dev)
    qi = torch.cat([torch.clamp_min(c - 0.3, 0.0), torch.clamp_max(c + 0.3, 1.0)], dim=1)
    splits = {"baseline": baseline_splits(nq, nx, dev), "new": fused_scan.splits_for(nq, nx, dev)}
    stream = cuda_lib.stream_ptr(q)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        qa, xa = q.to(dtype).contiguous(), x.to(dtype).contiguous()
        entry = "repro_filtered_topk" if dtype == torch.float32 else "repro_filtered_topk_bf16"
        for is_filter in (True, False):
            outs = {}

            def run(tag):
                s = splits[tag]
                part_d = torch.empty(s, nq, k, device=dev)
                part_i = torch.empty(s, nq, k, device=dev, dtype=torch.int32)
                vals = torch.empty(nq, k, device=dev)
                ids = torch.empty(nq, k, device=dev, dtype=torch.int32)
                outs[tag] = (vals, ids)
                fn = getattr(libs[tag], entry)
                return lambda: fn(qa.data_ptr(), xa.data_ptr(), oi.data_ptr(), qi.data_ptr(),
                                  part_d.data_ptr(), part_i.data_ptr(), vals.data_ptr(),
                                  ids.data_ptr(), nq, nx, d, k, int(is_filter), s, stream)

            calls = {tag: run(tag) for tag in libs}
            for tag, fn in calls.items():
                cuda_lib.check(fn(), f"filtered_topk ({tag})")
            torch.cuda.synchronize()
            broken = fused_scan.rule_violations(qa, xa, oi, qi, is_filter=is_filter,
                                                got=outs["new"], want=outs["baseline"])
            if broken:
                raise AssertionError(f"filtered_topk ({dtype}, is_filter={is_filter}): {broken}")
            ids_equal = bool(torch.equal(outs["new"][1], outs["baseline"][1]))
            rows.append(dict(in_turns(calls["baseline"], calls["new"], reps),
                             dtype=str(dtype).split(".")[-1], is_filter=is_filter,
                             splits=splits, within_rule=True, ids_equal=ids_equal,
                             rows_differ=int((outs["new"][1] != outs["baseline"][1])
                                             .any(dim=1).sum()),
                             shape=SHAPE_SCAN))
    return rows


def beam_draw(dev, g, B: int, E: int, L: int):
    """``chip_smoke.py`` phase 2's merge input: keys from a pool with ties
    and +inf, pads where +inf, the beam sorted."""
    pool = torch.tensor([0.25, 0.5, 1.0, 2.0, float("inf")], device=dev)
    bd = pool[torch.randint(0, 5, (B, E), generator=g, device=dev)]
    bp = torch.randint(0, 500_000, (B, E), generator=g, device=dev, dtype=torch.int32) << 1
    bp = torch.where(torch.isfinite(bd), bp, PAD_PAYLOAD)
    bd, o = torch.sort(bd, dim=-1, stable=True)
    bp = torch.gather(bp, -1, o)
    cd = pool[torch.randint(0, 5, (B, L), generator=g, device=dev)]
    cp = torch.randint(0, 500_000, (B, L), generator=g, device=dev, dtype=torch.int32) << 1
    cp = torch.where(torch.isfinite(cd), cp, PAD_PAYLOAD)
    return tuple(t.contiguous() for t in (bd, bp, cd, cp))


def all_pad_rows(cand_d, cand_p) -> torch.Tensor:
    """Rows whose candidates are all ``(+inf, PAD_PAYLOAD)``, bit for bit."""
    inf = torch.tensor(float("inf"), device=cand_d.device).view(torch.int32)
    return ((cand_d.view(torch.int32) == inf) & (cand_p == PAD_PAYLOAD)).all(dim=1)


def beam_merge_turns(libs: dict, case, reps: int = REPS_Q) -> dict:
    """One merge input through both trees' ``repro_beam_merge`` in turns."""
    bd, bp, cd, cp = case
    B, E = bd.shape
    L_in = cd.shape[1]
    L = next_pow2(max(L_in, 2))
    # the launch width of the shared-memory network (one block a row), which
    # earlier builds of the library read; this tree's kernel sizes its own
    threads = min(1024, max(32, max(L, E) // 2))
    stream = cuda_lib.stream_ptr(bd)

    def call(lib, out):
        return lib.repro_beam_merge(bd.data_ptr(), bp.data_ptr(), cd.data_ptr(), cp.data_ptr(),
                                    out[0].data_ptr(), out[1].data_ptr(), B, E, L_in, L,
                                    threads, stream)

    lg = L.bit_length() - 1
    ce_per_row = L // 2 * lg * (lg + 1) // 2 + E + E // 2 * (E.bit_length() - 1)
    nbytes = B * (2 * E + 2 * L_in) * 4 + B * 2 * E * 4
    return dict(bitwise_turns("beam_merge", libs, call, (2, B, E), bd.device, reps),
                bound_ms=max(nbytes / 3.35e12, B * ce_per_row * 2 / 67e12) * 1e3,
                shape=dict(B=B, E=E, L_in=L_in, L=L),
                all_pad_share=float(all_pad_rows(cd, cp).float().mean()))


def beam_merge_rows(libs: dict, dev):
    g = torch.Generator(device=dev).manual_seed(1234)
    for L in MERGE_LS:
        yield beam_merge_turns(libs, beam_draw(dev, g, MERGE_B, MERGE_E, L))


@contextlib.contextmanager
def recording_merges(keep: tuple[int, ...]):
    """Record every ``ops.beam_merge`` call's share of all-pad candidate
    rows and keep the inputs of the calls numbered in ``keep``."""
    shares, kept = [], {}
    merge = ops.beam_merge

    def recorder(beam_d, beam_p, cand_d, cand_p, **kw):
        if len(shares) in keep:
            kept[len(shares)] = tuple(t.clone() for t in (beam_d, beam_p, cand_d, cand_p))
        shares.append(float(all_pad_rows(cand_d, cand_p).float().mean()))
        return merge(beam_d, beam_p, cand_d, cand_p, **kw)

    ops.beam_merge = recorder
    try:
        yield shares, kept
    finally:
        ops.beam_merge = merge


def smoke_search(dev):
    """``chip_smoke.py``'s main path: its 1M corpus, build config and mixed
    batch (IF/IS/RS/RF cycling, RS with point windows)."""
    from repro_torch.core import Semantics, UGConfig, UGIndex
    from repro_torch.data import CorpusConfig, make_corpus, make_queries

    ccfg = CorpusConfig(n=SEARCH_N, dim=128, seed=0)
    cfg = UGConfig(ef_spatial=32, ef_attribute=64, max_edges_if=32, max_edges_is=32,
                   iterations=3)
    x, ints = make_corpus(ccfg, device=dev)
    idx = UGIndex.build(x, ints, cfg, seed=0, device=dev)
    cycle = [Semantics.IF, Semantics.IS, Semantics.RS, Semantics.RF]
    qv, wide = make_queries(ccfg, SEARCH_NQ, workload="uniform", device=dev)
    _, point = make_queries(ccfg, SEARCH_NQ, workload="point", device=dev)
    sems = [cycle[i % 4] for i in range(SEARCH_NQ)]
    is_rs = torch.tensor([s is Semantics.RS for s in sems], device=dev)
    qi = torch.where(is_rs[:, None], point, wide)
    return idx, (qv, qi, sems)


def profile_split(trace: dict, window: str, iters: int) -> dict:
    """Device idle share and per-iteration split of a chrome trace over the
    span of the ``window`` annotation (stretched to the last kernel's end)."""
    events = trace["traceEvents"]
    span = next(e for e in events if e.get("name") == window and e.get("cat") == "user_annotation")
    t0, t1 = span["ts"], span["ts"] + span["dur"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and e["ts"] + e.get("dur", 0) >= t0]
    t1 = max([t1] + [e["ts"] + e["dur"] for e in device])
    busy, end = 0.0, t0
    for e in sorted(device, key=lambda e: e["ts"]):
        s, f = max(e["ts"], end), e["ts"] + e["dur"]
        if f > s:
            busy += f - s
            end = f
    split = {"scorer": 0.0, "beam_merge": 0.0, "other_kernels": 0.0, "memcpy_memset": 0.0}
    count = dict.fromkeys(split, 0)
    for e in device:
        name = e["name"]
        key = ("memcpy_memset" if e["cat"] != "kernel" else "beam_merge" if "beam_merge" in name
               else "scorer" if "expand_score" in name else "other_kernels")
        split[key] += e["dur"]
        count[key] += 1
    sync = [e for e in events if e.get("cat") == "cpu_op"
            and e.get("name") == "aten::_local_scalar_dense" and t0 <= e["ts"] <= t1]
    wall = t1 - t0
    ms = 1e-3
    return dict(wall_ms=wall * ms, device_busy_ms=busy * ms, device_idle_share=1 - busy / wall,
                iters=iters, per_iter_wall_ms=wall * ms / iters,
                per_iter_device_ms={k: v * ms / iters for k, v in split.items()},
                launches=count, host_syncs=len(sync),
                per_iter_host_sync_ms=sum(e["dur"] for e in sync) * ms / iters)


def search_rows(libs: dict, dev, trace_path: pathlib.Path | None):
    t0 = time.perf_counter()
    idx, (qv, qi, sems) = smoke_search(dev)
    torch.cuda.synchronize()
    yield dict(part="search", build_seconds=time.perf_counter() - t0, n=SEARCH_N,
               queries=SEARCH_NQ, **SEARCH)
    with recording_merges(CAPTURE_ITERS) as (shares, kept):
        res = idx.search_mixed(qv, qi, sems, **SEARCH)
    yield dict(part="search", iters=res.iters, all_pad_share_by_iteration=shares[1:],
               entry_merge_all_pad_share=shares[0])
    for it, case in sorted(kept.items()):
        yield dict(kernel="beam_merge", captured_iteration=it, **beam_merge_turns(libs, case))
    del kept
    from torch.profiler import ProfilerActivity, profile, record_function

    idx.search_mixed(qv, qi, sems, **SEARCH)                  # warm-up
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = trace_path or pathlib.Path(tmp) / "trace.json"
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("search_batch"):
                res = idx.search_mixed(qv, qi, sems, **SEARCH)
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    yield dict(part="profile", trace=str(trace_path) if trace_path else None,
               **profile_split(trace, "search_batch", res.iters))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True, type=pathlib.Path,
                    help="the root of another tree of the repository")
    ap.add_argument("--trace", type=pathlib.Path, default=None,
                    help="keep the search batch's chrome trace in this file")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("turns: needs a CUDA card")
    no_tf32()
    dev = torch.device("cuda")
    base_info = {}
    libs = {"baseline": cuda_lib.load(cuda_lib.build(args.baseline / KERNELS / "csrc",
                                                     cuda_lib.BUILD_ROOT / "baseline",
                                                     base_info)),
            "new": cuda_lib.lib()}
    sources = ("expand_score.cu", "expand_score_q.cu", "expand_score_pq.cu", "fused_scan.cu",
               "beam_merge.cu")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    emit(device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         ptxas_baseline=ptxas(base_info, sources),
         ptxas=ptxas(cuda_lib.build_info, sources))
    for row in scorer_rows(libs, dev, REPS_Q):
        emit(**row)
    for row in filtered_topk_rows(libs, dev, REPS_SCAN, baseline_splits_for(args.baseline)):
        emit(kernel="filtered_topk", **row)
    for row in beam_merge_rows(libs, dev):
        emit(kernel="beam_merge", **row)
    for row in search_rows(libs, dev, args.trace):
        emit(**row)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
