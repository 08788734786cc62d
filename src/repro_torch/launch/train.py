"""End-to-end training driver: any ``--arch``, full or reduced, on one device
or over a ``--mesh AxB`` (``data=A, model=B``).

Checkpoints every ``--ckpt-every`` steps and at the end
(``AsyncCheckpointer``, which copies the trees to the host before the next
step writes into them), resumes from the latest checkpoint with
``--resume`` at its data cursor (the batches are a pure function of
``(seed, step)``, so a resumed run sees the batches a straight run would),
and prints the straggler monitor's recommendation beside the logged
steps.  The steps run in PyTorch's deterministic mode, so a resumed run's
parameters equal a straight run's bit for bit on the card too.

``--mesh AxB`` trains with the mesh step (``train/step.py``): parameters
and moments held as blocks under the model's shardings.  Without a
``torch.distributed`` group one process holds every shard; in a gloo group
(``launch/sharded.py::spawn_ranks`` with ``train_rank_program``, or any
launcher that initialises one) each rank holds its part, rank 0 prints and
writes the checkpoints.  ``--resume`` restores through the shardings, onto
the run's own mesh or onto another (``ft.elastic.resume``).

Example::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-32b --reduced \\
        --steps 50 --batch 8 --seq 64 --ckpt-dir build/ckpt --device cpu
"""
from __future__ import annotations

import os

# cuBLAS reads its workspace setting once, at the process's first product:
# deterministic mode needs it set before torch runs anything on the card
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import argparse  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from repro_torch.ckpt import AsyncCheckpointer, latest_step, restore  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.data import LMDataConfig, lm_batch  # noqa: E402
from repro_torch.ft import StepTimer, resume  # noqa: E402
from repro_torch.kernels.util import resolve_device  # noqa: E402
from repro_torch.launch.mesh import is_rank0, make_mesh  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.train import AdamWConfig, make_train_step, optim  # noqa: E402
from repro_torch.train.step import deterministic  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", default=None, help="e.g. 4x2 => (data=4, model=2)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' trains on the CPU)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    spec = get_arch(args.arch)
    cfg = spec.reduced if args.reduced else spec.config
    model = get_model(cfg)
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 2),
                       total_steps=args.steps)
    dcfg = LMDataConfig(vocab=cfg.vocab, batch=args.batch, seq=args.seq)
    frames_kw = {}
    if cfg.family == "encdec":
        frames_kw = dict(frames_dim=cfg.d_model, frames_len=max(args.seq // 2, 4))

    mesh = shard_kw = None
    if args.mesh:

        dims = tuple(int(x) for x in args.mesh.split("x"))
        mesh = make_mesh(dims, ("data", "model")[: len(dims)], device=dev)
        pshard = model.shardings(mesh)
        shard_kw = dict(param_shardings=pshard,
                        opt_shardings=optim.AdamWState(None, pshard, pshard))
    say = print if is_rank0() else (lambda *a, **k: None)

    with deterministic(dev):
        start_step = 0
        params = opt_state = None
        if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
            tmpl_p = model.shapes()
            tmpl_o = optim.init(ocfg, tmpl_p)
            if mesh is not None:
                params, opt_state, meta = resume(args.ckpt_dir, model, tmpl_o, mesh)
            else:
                params, opt_state, meta = restore(args.ckpt_dir, params_template=tmpl_p,
                                                  opt_template=tmpl_o, device=dev)
            start_step = meta["data_cursor"]
            say(f"[train] resumed at step {start_step} from {args.ckpt_dir}", flush=True)
        if params is None:
            params = model.init(torch.Generator(device=dev).manual_seed(0))
            if mesh is not None:
                from repro_torch.launch.shardings import shard_tree

                params = shard_tree(params, mesh, model.specs(mesh))
            opt_state = optim.init(ocfg, params)

        step_fn = make_train_step(model, ocfg, mesh, microbatches=args.microbatches,
                                  donate=True)
        ckpt = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
        shard_kw = shard_kw or {}
        timer = StepTimer()
        for step in range(start_step, args.steps):
            batch = lm_batch(dcfg, step, device=dev, **frames_kw)
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])          # the step's sync
            dt = time.perf_counter() - t0
            timer.record(dt)
            if step % args.log_every == 0 or step == args.steps - 1:
                rec = timer.recommendation()
                say(f"[train] step {step:5d} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} {dt * 1e3:.0f}ms"
                      + (f"  [ft: {rec}]" if rec else ""), flush=True)
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, params, opt_state, data_cursor=step + 1, **shard_kw)
        if ckpt:
            ckpt.save(args.steps, params, opt_state, data_cursor=args.steps, **shard_kw)
            ckpt.wait()
            say(f"[train] final checkpoint at {ckpt.last_path}", flush=True)
    return 0



if __name__ == "__main__":
    sys.exit(main())
