"""Profile one train step on one card: where a step's time goes.

    python -m repro_torch.bench.train_trace [--arch qwen1.5-4b] [--batch 4] [--seq 512]
        [--trace FILE]

Initialises the arch's full-width config from a seeded generator (bf16),
float32 moments, runs one warm-up step, then traces one more step's two
halves with ``torch.profiler``: the loss and its gradients
(``train.step.value_and_grad``) and the AdamW update in place
(``optim.update``), as ``make_train_step(donate=True)`` runs them.  The
steps run in PyTorch's deterministic mode, as ``launch/train.py`` runs
them.  Prints one JSON object: for each
half, its traced wall, device busy time and idle share, its kernel
launches, the kernel time split between the library's matrix products and
the other kernels, and the kernels that took the most time; the step's
wall without the profiler beside it.
"""
from __future__ import annotations

import os

# deterministic mode's cuBLAS needs this before the process's first product
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from repro_torch.bench.embed_trace import trace_split  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import LMDataConfig, lm_batch  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.train import AdamWConfig, optim  # noqa: E402
from repro_torch.train.step import deterministic, value_and_grad  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--trace", type=pathlib.Path, default=None,
                    help="keep the step's chrome trace in this file")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("train_trace: needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile, record_function

    dev = torch.device("cuda")
    cfg = get_arch(args.arch).config
    model = get_model(cfg)
    with deterministic(dev):
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        ocfg = AdamWConfig(warmup_steps=2, total_steps=8)
        opt = optim.init(ocfg, params)
        dcfg = LMDataConfig(cfg.vocab, args.batch, args.seq)

        def step(i):
            _, _, grads = value_and_grad(model, params, lm_batch(dcfg, i, device=dev))
            return optim.update(ocfg, opt, params, grads, inplace=True)[1]

        opt = step(0)                                        # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt = step(1)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        batch = lm_batch(dcfg, 2, device=dev)
        with tempfile.TemporaryDirectory() as tmp:
            path = args.trace or pathlib.Path(tmp) / "trace.json"
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                with record_function("value_and_grad"):
                    _, _, grads = value_and_grad(model, params, batch)
                    torch.cuda.synchronize()
                with record_function("update"):
                    opt = optim.update(ocfg, opt, params, grads, inplace=True)[1]
                    torch.cuda.synchronize()
            prof.export_chrome_trace(str(path))
            trace = json.loads(path.read_text())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps(dict(card=smi, arch=args.arch, dtype=str(cfg.dtype), batch=args.batch,
                          seq=args.seq,
                          step_seconds_untraced=step_s,
                          trace=str(args.trace) if args.trace else None,
                          value_and_grad=trace_split(trace, "value_and_grad", last=False),
                          update=trace_split(trace, "update"))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
