"""How far the tensor-parallel mesh step lies from the one-device step,
over several seeds, beside how far the unsplit data-parallel step lies:
the readings that ``chip_smoke.py`` phase 18's bounds (``FAMILY_TP_TOL``)
are set from.

    python -m repro_torch.bench.split_rounding --seeds 0 1 2 3      # on the card
    python -m repro_torch.bench.split_rounding --device cpu --seeds 1 2 3 4 5

For rwkv6-1.6b, zamba2-2.7b and seamless-m4t-medium (on the card cut as
phase 18 cuts them, B = 2, S = 256; on the CPU their reduced configs, B
= 4, S = 16 and 16 frames) and each seed,
two gloo processes take one donated step of each cell
(``launch/sharded.py::tp_check_all``, the one-device steps first): the
split step on (1, 2) in float32 and in float64, and the unsplit
data-parallel step on (2, 1) in float32.  The unsplit step runs no split
code: its distance from the one-device step is the rounding of the
step's shape-dependent products as the tower amplifies it.  So is the
distance of a one-device step whose weights were each scaled by ``1 +
2^-24 · N(0, 1)`` (about one float32 rounding; ``perturbed``).  A float64
step still rounds its norms, scans, attention and loss in float32, as
the reference computes them.  Prints one JSON object a run: step 1's
largest parameter error and its loss and grad norm relative to the
one-device step's, the card's name and power limit beside them (``cpu``
off the card).  The steps run in PyTorch's deterministic mode under
phase 18's ``AdamWConfig(eps=1e-3)``.

With ``--serve`` it reads the same for ``chip_smoke.py`` phase 19's split
prefill and decode (its bounds, ``SERVE_TP_TOL``): for each of phase 19's
cells (on the card qwen3-32b 2 layers on (1, 2) and (1, 16), minicpm3-4b 2
layers and qwen3-moe 1 layer on (1, 2), B = 2, a prompt of 240 in a cache
of 256, 16 decode steps; on the CPU their reduced configs, (1, 16) cut to
(1, 4), B = 4, a prompt of 24 in a cache of 32, 8 steps) and each seed,
``launch/sharded.py::serve_check_all`` in two gloo processes, and a
one-device run from weights moved as above: ``max |split − one device| /
max |one device|`` of the prefill's logits and caches, the decode steps'
logits and the last caches, the perturbed run's beside them, and whether
the next tokens agree::

    python -m repro_torch.bench.split_rounding --serve --seeds 0 1 2 3
"""
from __future__ import annotations

import os

# deterministic mode's cuBLAS needs this before the process's first product
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402

import torch  # noqa: E402

# phase 18's cuts: layers (an encoder-decoder's encoder too) and frames
CUTS = {"rwkv6-1.6b": dict(layers=2), "zamba2-2.7b": dict(layers=6),
        "seamless-m4t-medium": dict(layers=2, enc_layers=2, frames=256)}
SHAPE = {"cuda": (2, 256), "cpu": (4, 16)}      # (B, S) on the card and on the CPU
OPT = dict(lr=1e-3, eps=1e-3, warmup_steps=2, total_steps=8)      # phase 18's
THREADS = 1                    # torch threads a rank
PERTURB = 2.0 ** -24           # the perturbed one-device step's relative weight noise
# (name, mesh, dtypes): the split step in both dtypes, the unsplit step in float32
STEPS = (("split", (1, 2), ("float32", "float64")), ("unsplit", (2, 1), ("float32",)))


# phase 19's cells: (arch, layers, mesh), and its shapes on the card and on the CPU
SERVE_CELLS = (("qwen3-32b", 2, (1, 2)), ("qwen3-32b", 2, (1, 16)), ("minicpm3-4b", 2, (1, 2)),
               ("qwen3-moe-235b-a22b", 1, (1, 2)))
SERVE_SHAPE = {"cuda": dict(batch=2, prompt=240, cache=256, steps=16, lens=[240, 229]),
               "cpu": dict(batch=4, prompt=24, cache=32, steps=8, lens=[24, 20, 13, 7])}


def card_name(device) -> str:
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def cells_of(device: str, seed: int) -> list[tuple[str, dict]]:
    """``(step name, tp_check_rank params)`` of each cell of one seed."""
    from repro_torch.configs import get_arch

    reduced = device == "cpu"
    batch, seq = SHAPE[device]
    out = []
    for arch, cut in CUTS.items():
        cut = dict(cut)
        if reduced:                      # the reduced config's own depth
            cfg = get_arch(arch).reduced
            cut["layers"] = cfg.n_layers
            if cfg.family == "encdec":
                cut.update(enc_layers=cfg.enc_layers, frames=seq)
        for name, mesh, dtypes in STEPS:
            out.append((name, dict(arch=arch, reduced=reduced, batch=batch, seq=seq,
                                   seed=seed, opt=OPT, device=device, threads=THREADS,
                                   mesh=mesh, **cut,
                                   runs=[dict(dtype=d, steps=1, params=True) for d in dtypes])))
    return out


def serve_cells_of(device: str, seed: int) -> list[dict]:
    """``serve_check_all``'s cells of one seed."""
    from repro_torch.configs import get_arch

    reduced = device == "cpu"
    out = []
    for arch, layers, mesh in SERVE_CELLS:
        if reduced:
            layers, mesh = get_arch(arch).reduced.n_layers, (1, min(mesh[1], 4))
        out.append(dict(arch=arch, reduced=reduced, layers=layers, mesh=mesh, dtype="float32",
                        seed=seed, device=device, threads=THREADS, **SERVE_SHAPE[device]))
    return out


def serve_readings(device: str, seeds, work: pathlib.Path, card: str) -> None:
    """The ``--serve`` readings (module docstring), a JSON line a cell and
    seed."""
    from repro_torch.launch.sharded import (
        _rel, _serve_parts, serve_check_all, serve_reference,
    )

    for seed in seeds:
        cells = serve_cells_of(device, seed)
        done = serve_check_all(cells, work / str(seed), timeout=900)
        for i, (params, cell) in enumerate(zip(cells, done)):
            path = work / str(seed) / str(i) / "perturbed.pt"
            serve_reference(params, path, perturb=PERTURB)
            one, moved = (_serve_parts(torch.load(p)) for p in (
                work / str(seed) / str(i) / "one_device.pt", path))
            next_moved = all(torch.equal(a, b) for a, b in zip(
                torch.load(path)["next"], torch.load(work / str(seed) / str(i) /
                                                     "one_device.pt")["next"]))
            print(json.dumps(dict(
                arch=params["arch"], reduced=params["reduced"], mesh=params["mesh"], seed=seed,
                card=card, split=cell["rel"], perturbed={k: _rel(moved[k], one[k]) for k in one},
                next_equal=cell["next_equal"], perturbed_next_equal=next_moved,
                bitwise_one_process=cell["bitwise_one_process"],
                decode_ms=[x * 1e3 for x in cell["logs"][0]["seconds"][1:]])), flush=True)
        shutil.rmtree(work / str(seed))


def main(argv=None) -> int:
    from repro_torch.launch.sharded import (
        start_forkserver, stop_forkserver, tp_check_all, tp_reference,
    )

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", nargs="+", type=int, default=[0])
    ap.add_argument("--device", default="cuda", choices=list(SHAPE))
    ap.add_argument("--serve", action="store_true",
                    help="read phase 19's split prefill and decode instead")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("split_rounding: no CUDA device is available (pass --device cpu)")
    card = card_name(args.device)
    work = pathlib.Path(tempfile.mkdtemp(prefix="split_rounding_"))
    start_forkserver(("repro_torch.launch.sharded", "torch._dynamo"))
    try:
        if args.serve:
            serve_readings(args.device, args.seeds, work, card)
            return 0
        for seed in args.seeds:
            cells = cells_of(args.device, seed)
            done = tp_check_all([p for _, p in cells], work / str(seed), timeout=900)
            for (name, params), cell in zip(cells, done):
                for j, ref in enumerate(cell["references"]):
                    logs = [lg["runs"][j] for lg in cell["logs"]]
                    print(json.dumps(dict(
                        arch=params["arch"], reduced=params["reduced"], seed=seed, step=name,
                        mesh=params["mesh"], dtype=logs[0]["dtype"], card=card,
                        max_param_err=max(lg["max_param_err"] for lg in logs),
                        **{f"{k}_rel": abs(logs[0][k][0] - ref[k]) / abs(ref[k])
                           for k in ("loss", "grad_norm")},
                        seconds=logs[0]["seconds"][0], one_device_seconds=ref["seconds"])),
                        flush=True)
                if name != "split":
                    continue
                # the one-device step from weights perturbed by about one rounding
                run = cell["params"]["runs"][0]
                path = work / str(seed) / f"perturbed_{params['arch']}.pt"
                got = tp_reference(dict(cell["params"], perturb=PERTURB), run, path)
                ref = cell["references"][0]
                kept = [torch.load(p, map_location="cpu")["params"]
                        for p in (run["reference"], path)]
                print(json.dumps(dict(
                    arch=params["arch"], reduced=params["reduced"], seed=seed, step="perturbed",
                    mesh=None, dtype=run["dtype"], card=card,
                    max_param_err=max(float((a[2] - kept[1][k][2]).abs().max())
                                      for k, a in kept[0].items()),
                    **{f"{k}_rel": abs(got[k] - ref[k]) / abs(ref[k])
                       for k in ("loss", "grad_norm")})), flush=True)
            shutil.rmtree(work / str(seed))
    finally:
        stop_forkserver()
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
