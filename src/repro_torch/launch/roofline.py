"""Roofline analysis: three terms per dry-run record, with the H100's rates.

    compute    = FLOPs      / 989e12 FLOP/s  (bf16 dense, tensor cores)
    memory     = HBM bytes  / 3.35e12 B/s    (HBM3)
    collective = coll_bytes / 50e9 B/s       (one 400 Gb/s InfiniBand NDR link)

The dry-run's figures are per card (``launch/dryrun.py``: what one card of
the mesh runs), so each term is a per-card quantity over a per-card rate.
MODEL_FLOPS is 6·N·D (dense) or 6·N_active·D (MoE), the harness's
definition; its ratio to (FLOPs × cards) flags remat and redundant work.

The rates are the H100 SXM's (NVIDIA's H100 datasheet; ``chip_smoke.py``'s
``PEAK_BF16_PER_S``/``PEAK_BYTES_PER_S``).  The collective rate is the one
a 256- or 512-card mesh meets: its collectives cross nodes, over one
400 Gb/s InfiniBand NDR link a GPU (50e9 B/s).  Within one node NVLink 4
moves 450e9 B/s a direction; gloo between two processes sharing one card
moved ~0.4e9 B/s (PERF.md §5), which is what the port's mesh step meets
today.  The constant keeps the reference's name, ``ICI_BW``.

Reads the JSONL written by ``repro_torch.launch.dryrun``::

    python -m repro_torch.launch.roofline results/dryrun.jsonl [--json-out F]
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys

PEAK_FLOPS = 989e12     # bf16 dense a card (H100 SXM tensor cores)
HBM_BW = 3.35e12        # bytes/s a card (H100 SXM HBM3)
ICI_BW = 50e9           # bytes/s a card: one 400 Gb/s InfiniBand NDR link

_CHIPS = {"single": 256, "multi": 512}


def model_flops(arch: str, shape) -> float:
    """6·N(_active)·D per the harness definition (D = tokens processed);
    ``shape`` is a shape's name or a record holding it under ``"shape"``."""
    from repro_torch.configs.registry import ARCHS, SHAPES

    name = shape["shape"] if isinstance(shape, dict) else shape
    if arch not in ARCHS or name not in SHAPES:
        return 0.0
    cfg = ARCHS[arch].config
    sh = SHAPES[name]
    n_active = cfg.active_param_count()
    if sh.kind == "train":
        tokens = sh.global_batch * sh.seq_len
        return 6.0 * n_active * tokens
    if sh.kind == "prefill":
        tokens = sh.global_batch * sh.seq_len
        return 2.0 * n_active * tokens        # forward only
    # decode: one token per request
    return 2.0 * n_active * sh.global_batch


def _cards(rec: dict) -> int:
    """The mesh's cards: the production meshes' counts, else the product of
    the record's ``mesh_shape``."""
    mesh = rec.get("mesh", "single")
    if mesh in _CHIPS:
        return _CHIPS[mesh]
    shape = rec.get("mesh_shape") or {}
    return math.prod(shape.values()) if shape else _CHIPS["single"]


def analyze(rec: dict) -> dict:
    chips = _cards(rec)
    flops_dev = rec.get("flops", 0.0)
    bytes_dev = rec.get("bytes_accessed", 0.0)
    coll_dev = rec.get("collective_bytes", 0)

    t_compute = flops_dev / PEAK_FLOPS
    t_memory = bytes_dev / HBM_BW
    t_coll = coll_dev / ICI_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    mf = model_flops(rec.get("arch", ""), rec)
    hlo_total = flops_dev * chips
    useful = mf / hlo_total if hlo_total else 0.0
    # roofline fraction: useful work over what the dominant term's time buys
    step_time = bound
    achievable = mf / (chips * PEAK_FLOPS)
    frac = achievable / step_time if step_time > 0 else 0.0
    return {
        **{k: rec.get(k) for k in ("arch", "shape", "mesh", "ok", "skipped")},
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops": mf,
        "hlo_flops_total": hlo_total,
        "useful_ratio": useful,
        "roofline_fraction": frac,
    }


def fmt_table(rows: list[dict]) -> str:
    hdr = (
        f"{'arch':26s} {'shape':12s} {'mesh':6s} {'compute(s)':>11s} "
        f"{'memory(s)':>11s} {'coll(s)':>11s} {'bound':>10s} "
        f"{'useful':>7s} {'roofline':>9s}"
    )
    out = [hdr, "-" * len(hdr)]
    for r in rows:
        if r.get("skipped"):
            out.append(f"{r['arch']:26s} {r['shape']:12s} {r['mesh']:6s} "
                       f"{'— skipped: sub-quadratic attention required —':>62s}")
            continue
        if not r.get("ok", True):
            out.append(f"{r['arch']:26s} {r['shape']:12s} {r['mesh']:6s} FAILED")
            continue
        out.append(
            f"{r['arch']:26s} {r['shape']:12s} {r['mesh']:6s} "
            f"{r['t_compute_s']:11.4f} {r['t_memory_s']:11.4f} "
            f"{r['t_collective_s']:11.4f} {r['dominant']:>10s} "
            f"{r['useful_ratio']:7.3f} {r['roofline_fraction']:9.3f}"
        )
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("jsonl", help="dryrun JSONL file")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    rows = []
    seen = {}
    for line in pathlib.Path(args.jsonl).read_text().splitlines():
        rec = json.loads(line)
        seen[(rec.get("arch"), rec.get("shape"), rec.get("mesh"))] = rec
    for rec in seen.values():
        rows.append(analyze(rec))
    print(fmt_table(rows))
    if args.json_out:
        pathlib.Path(args.json_out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
