"""Time this tree's scorer kernels (``expand_score`` f32 and bf16,
``expand_score_q``, ``expand_score_pq``) and ``filtered_topk`` against
another tree's, in turns, on one card.

    python -m repro_torch.bench.turns --baseline DIR

``DIR`` is the root of another tree of the repository (for example the
parent commit, unpacked with ``git archive``).  Its ``kernels/csrc`` is
built with this tree's ``cuda_lib.build`` under
``build/repro_torch_kernels/baseline``, and its ``filtered_topk`` gets the
corpus ranges its own ``fused_scan.splits_for`` picks.  Both builds'
``-Xptxas -v`` lines for these kernels are printed.  Each kernel runs at
the main path's shape (the scorers: n = 1M, d = 128, B = 10,000, C = 256,
20 % masked, the same candidates on an int8, a bf16, an f32 and a pq
(m = 16) plane; ``filtered_topk``: 10,000 queries × 1M rows × 128,
k = 10, IF and IS, f32 and bf16) in the order baseline, this tree, this
tree, baseline, each turn the mean of CUDA-event timed back-to-back calls
after a warm-up.  The answers are checked first: the scorers bitwise
against the baseline's, ``filtered_topk`` within
``fused_scan.rule_violations`` of the baseline's.  Prints one JSON object
per line.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import subprocess

import torch

from repro_torch.kernels import cuda_lib, fused_scan
from repro_torch.kernels.util import no_tf32

SHAPE_Q = dict(n=1_000_000, d=128, B=10_000, C=256)
PQ_M = 16                      # pq subspaces at d = 128
SHAPE_SCAN = dict(nq=10_000, nx=1_000_000, d=128, k=10)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True, type=pathlib.Path,
                    help="the root of another tree of the repository")
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
    sources = ("expand_score.cu", "expand_score_q.cu", "expand_score_pq.cu", "fused_scan.cu")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    emit(device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         ptxas_baseline=ptxas(base_info, sources),
         ptxas=ptxas(cuda_lib.build_info, sources))
    for row in scorer_rows(libs, dev, REPS_Q):
        emit(**row)
    for row in filtered_topk_rows(libs, dev, REPS_SCAN, baseline_splits_for(args.baseline)):
        emit(kernel="filtered_topk", **row)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
