"""Elastic rescaling: re-plan the mesh when devices join or leave, and
restore the latest checkpoint re-sharded onto the new mesh.

The checkpoint format stores full logical arrays (``ckpt/store.py``), so the
restore path is mesh-agnostic — this module only decides the new mesh shape
and drives the re-sharded restore and the deterministic data-cursor resume.
"""
from __future__ import annotations

import dataclasses

from repro_torch.ckpt import store


@dataclasses.dataclass(frozen=True)
class RescalePlan:
    mesh_shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    dropped_pods: int = 0


def plan_rescale(
    n_devices: int,
    *,
    model_parallel: int,
    pods: int = 1,
    axis_names: tuple[str, ...] = ("pod", "data", "model"),
) -> RescalePlan:
    """Choose the largest (pod, data, model) mesh that fits ``n_devices``.

    Model parallelism is preserved (changing the tensor-parallel degree
    would invalidate the parameter layout of attention-head sharding); pods
    shrink first, then the data axis, as real incidents lose capacity.
    """
    if n_devices % model_parallel:
        raise ValueError(
            f"{n_devices} devices not divisible by model_parallel={model_parallel}"
        )
    replicas = n_devices // model_parallel
    use_pods = pods
    while use_pods > 1 and replicas % use_pods:
        use_pods -= 1
    data = replicas // use_pods
    if use_pods > 1:
        return RescalePlan((use_pods, data, model_parallel), axis_names, pods - use_pods)
    return RescalePlan((data, model_parallel), axis_names[1:], pods - 1 if pods > 1 else 0)


def plan_serve_rescale(
    n_devices: int,
    shard_parallel: int,
    *,
    axis_names: tuple[str, ...] = ("replica", "shard"),
) -> RescalePlan:
    """Replica-count planning for a row-sharded serving store.

    The shard axis plays the role model parallelism plays in training: the
    index is partitioned ``shard_parallel`` ways and re-sharding it means
    rebuilding per-shard graphs, so the shard degree is preserved and the
    *replica* (query data-parallel) axis absorbs capacity changes.  Devices
    that do not fill a whole replica group are dropped (``dropped_pods``).
    """
    if shard_parallel <= 0 or n_devices <= 0:
        raise ValueError(
            f"need positive device/shard counts, got n_devices={n_devices} "
            f"shard_parallel={shard_parallel}")
    replicas = n_devices // shard_parallel
    if replicas == 0:
        raise ValueError(
            f"{n_devices} devices cannot hold one {shard_parallel}-shard "
            f"replica of the store")
    dropped = n_devices - replicas * shard_parallel
    return RescalePlan((replicas, shard_parallel), axis_names, dropped)


def resume(
    ckpt_dir,
    model,
    opt_template,
    mesh,
    *,
    step: int | None = None,
):
    """Restore the latest checkpoint (or ``step``) re-sharded onto ``mesh``.

    Returns ``(params, opt_state, meta)`` with every parameter and moment
    leaf as this process's block under the model's shardings on ``mesh``
    (the optimizer's step counter whole, on the mesh's device);
    ``meta["data_cursor"]`` is the deterministic resume point of the
    synthetic data (a pure function of (seed, step))."""
    from repro_torch.train import optim

    pshard = model.shardings(mesh)
    oshard = None
    if opt_template is not None:
        oshard = optim.AdamWState(None, pshard, pshard)
    return store.restore(
        ckpt_dir,
        step,
        params_template=model.shapes(),
        opt_template=opt_template,
        param_shardings=pshard,
        opt_shardings=oshard,
        device=mesh.device,
    )
