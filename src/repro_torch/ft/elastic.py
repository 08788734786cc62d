"""Elastic rescaling: re-plan the device mesh when devices join or leave.

The checkpoint format stores full logical arrays (``ckpt/store.py``), so a
restore is mesh-agnostic; this module only decides the new mesh shape.  The
reference's ``resume`` (a model's re-sharded restore with its optimizer
state) comes with the LM towers.
"""
from __future__ import annotations

import dataclasses


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
