"""Train-step factory: loss → grads → AdamW, with microbatch accumulation.

``make_train_step`` is the reference's single-device path
(``mesh=None``): gradients come from ``torch.autograd.grad`` over
detached views of the parameter leaves that require grad, so nothing
accumulates into ``.grad``.  The mesh path (shardings, the compressed data-parallel
exchange) waits for ``models.common.SLICE_TRAINING`` (item 9's slice 4).

Determinism.  The backward passes hold float scatter-adds (the embedding
lookup's, the MoE dispatch's and combine's), which run as atomics on the
card unless PyTorch's deterministic mode is on.  :func:`deterministic`
turns it on for a block; the training entry points (``launch/train.py``,
``bench_lm_steps``, ``chip_smoke.py``) run their steps inside it, with
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before their first cuBLAS call.
"""
from __future__ import annotations

import contextlib
import os

import torch

from repro_torch.models.api import Model
from repro_torch.models.common import SLICE_TRAINING, tree_leaves, tree_map
from repro_torch.train import optim

CUBLAS_WORKSPACE = ":4096:8"   # the cuBLAS workspace deterministic mode needs


@contextlib.contextmanager
def deterministic(device=None):
    """PyTorch's deterministic algorithms for the block, then the previous
    setting.  On the card (``device`` of type cuda) cuBLAS also needs
    ``CUBLAS_WORKSPACE_CONFIG`` set before the process's first cuBLAS
    call; a missing one raises here rather than at the first product."""
    on_card = device is not None and torch.device(device).type == "cuda"
    if on_card and not os.environ.get("CUBLAS_WORKSPACE_CONFIG"):
        raise RuntimeError("deterministic training on the card needs "
                           f"CUBLAS_WORKSPACE_CONFIG={CUBLAS_WORKSPACE} in the environment "
                           "before the first cuBLAS call")
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def _scalar(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach()
    return torch.tensor(float(v), dtype=torch.float32, device=device)


def value_and_grad(model: Model, params, batch):
    """``(loss, metrics, grads)`` of ``model.loss``: grads a tree like
    ``params`` (zeros for a leaf the loss does not read), by
    ``torch.autograd.grad`` over detached leaves that require grad."""
    paths = [path for path, _ in tree_leaves(params)]
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = [leaf for _, leaf in tree_leaves(live)]
    with torch.enable_grad():
        loss, metrics = model.loss(live, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    dev = leaves[0].device
    return (loss.detach(), {k: _scalar(v, dev) for k, v in metrics.items()},
            optim.tree_from_paths(params, dict(zip(paths, grads))))


def make_train_step(model: Model, opt_cfg: optim.AdamWConfig, mesh=None, *,
                    microbatches: int = 1, donate: bool = True):
    """Returns ``(params, opt_state, batch) -> (params, opt_state, metrics)``.

    ``microbatches > 1`` splits the batch on dim 0 and sums the gradients
    from float32 zeros (each add promoted to float32), then divides by
    ``microbatches``; ``metrics`` then holds only ``loss`` and the
    optimizer's stats.  ``donate`` updates the parameters and moments in
    place and returns the same trees: the caller must not reuse the old
    ones (JAX's donation contract)."""
    if mesh is not None:
        raise NotImplementedError(f"the mesh train step is not ported yet ({SLICE_TRAINING})")

    def step_fn(params, opt_state, batch):
        if microbatches > 1:
            def part(a, i):
                b = a.shape[0] // microbatches
                return a[i * b:(i + 1) * b]

            dev = tree_leaves(params)[0][1].device
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            g_acc = dict(tree_leaves(grads))
            loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(microbatches):
                mb = {k: part(v, i) for k, v in batch.items()}
                loss, _, g = value_and_grad(model, params, mb)
                for path, gl in tree_leaves(g):
                    g_acc[path].add_(gl)
                loss_sum = loss_sum + loss
                del g
            for acc in g_acc.values():
                acc.div_(microbatches)
            loss = loss_sum / microbatches
            metrics = {}
        else:
            loss, metrics, grads = value_and_grad(model, params, batch)
        new_params, new_opt, stats = optim.update(opt_cfg, opt_state, params, grads,
                                                  inplace=donate)
        del grads
        return new_params, new_opt, {"loss": loss, **metrics, **stats}

    return step_fn


def make_eval_step(model: Model, mesh=None):
    """Returns ``(params, batch) -> {"loss", **metrics}`` (no gradients)."""
    if mesh is not None:
        raise NotImplementedError(f"the mesh eval step is not ported yet ({SLICE_TRAINING})")

    @torch.no_grad()
    def eval_fn(params, batch):
        loss, metrics = model.loss(params, batch)
        dev = tree_leaves(params)[0][1].device
        return {"loss": loss, **{k: _scalar(v, dev) for k, v in metrics.items()}}

    return eval_fn
