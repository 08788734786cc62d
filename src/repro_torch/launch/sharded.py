"""Work across processes: a launcher, and the rank programs of the
row-sharded index and of the mesh half of training.

:func:`spawn_ranks` starts ``world`` processes with the ``spawn`` method.
Each joins one ``torch.distributed`` group through a file store, with a time
limit on every collective, and runs ``target(rank, world, *args)``.  The
launcher waits for all of them and raises when one fails or the time limit
passes, ending the rest, so a hung collective fails its caller instead of
hanging it.

:func:`rank_program` is one rank of a sharded build and search over a
``("data",)`` mesh of ``S`` shards, ``S / world`` a process: it writes its
rows of the built graph, the global ring KNN of its rows, the mixed
sharded search's answer (the same on every rank), optionally that answer on
a two-axis mesh (hierarchical and flat merge), and the ring collectives on
known inputs, to ``out_dir/rank{rank}.npz``.  The multi-process tests and
``chip_smoke.py`` hold those files against one process's results::

    spawn_ranks(rank_program, 2, (inputs_npz, out_dir, params),
                backend="gloo", init_file=path_under_build_or_tmp)

:func:`train_rank_program` is one rank of the mesh train step
(:func:`run_mesh_train`) and of the expert-parallel MoE layer
(:func:`run_ep_layer`); those two functions are what one process holding
every shard runs too, so the tests and ``chip_smoke.py`` hold the ranks'
gathered results to one process's bit for bit.  :func:`tp_check_rank`
holds the tensor-parallel mesh step at an arch's full width against the
one-device step, a rank's blocks at a time, or against a one-device step
that :func:`tp_reference` ran before the ranks started (where the card
cannot hold both); :func:`tp_check_cells` runs it for several archs in one
start of the ranks, and :func:`tp_check_all` runs their one-device steps
first, then those ranks.  :func:`serve_check_all` does the same for the
decoders' split prefill and decode (``launch/dryrun.py``'s
``prefill_step``/``serve_step``): each cell's one-device run
(:func:`serve_reference`) and its split with every shard in this
process first, then :func:`serve_check_rank` in the ranks.
"""
from __future__ import annotations

import datetime
import os
import pathlib
import time
from multiprocessing import forkserver, resource_tracker

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.build import UGConfig
from repro_torch.core.sharded import (
    build_sharded_store, make_ring_knn_fn, make_sharded_search_fn, shard_index,
)
from repro_torch.distributed import ring_all_gather, ring_reduce_scatter
from repro_torch.launch.mesh import GROUP_TIMEOUT, make_mesh
from repro_torch.models.common import P, tree_leaves


def _rank_main(target, rank: int, world: int, backend: str, init_file: str,
               timeout: float, args: tuple) -> None:
    # a collective waits at most the launch's limit, and never past the
    # mesh groups' own
    limit = min(datetime.timedelta(seconds=timeout), GROUP_TIMEOUT)
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=limit)
    try:
        target(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(target, world: int, args: tuple = (), *, backend: str = "gloo",
                init_file, timeout: float = 120.0, start: str = "spawn") -> None:
    """Run ``target(rank, world, *args)`` in ``world`` spawned processes of
    one process group (``init_file`` must not exist yet).  Raises
    ``RuntimeError`` when a process exits non-zero and ``TimeoutError``
    when they have not all ended after ``timeout`` seconds; either way no
    process is left running, the resource tracker that the launch started
    included.  ``start`` is the multiprocessing start method: ``"spawn"``,
    or ``"forkserver"``, whose processes fork from a server that has
    already imported its preloaded modules (the caller starts and stops
    that server)."""
    init_file = pathlib.Path(init_file)
    if init_file.exists():
        raise FileExistsError(f"{init_file} exists: a file store needs a fresh file")
    ctx = mp.get_context(start)
    # the first spawned process starts multiprocessing's resource tracker,
    # which some Python 3.12 releases leave to outlive this process
    tracker_was_running = resource_tracker._resource_tracker._fd is not None
    procs = [ctx.Process(target=_rank_main,
                         args=(target, r, world, backend, str(init_file), timeout, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(f"ranks {failed} of {world} failed "
                                   f"(exit codes {[procs[r].exitcode for r in failed]})")
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after {timeout} s")
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"ranks {failed} of {world} failed "
                               f"(exit codes {[procs[r].exitcode for r in failed]})")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        if not tracker_was_running:
            resource_tracker._resource_tracker._stop()  # ends it and waits for it


def start_forkserver(preload) -> None:
    """Start multiprocessing's fork server for ``spawn_ranks(start=
    "forkserver")``; it imports the modules of ``preload`` while the caller
    goes on, and each process forked from it later starts with them."""
    mp.set_forkserver_preload(list(preload))
    forkserver.ensure_running()


def stop_forkserver() -> None:
    """End the fork server and the resource tracker that it started."""
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


def collective_inputs(mesh, axis: str, width: int = 3):
    """Known per-shard inputs of the ring collectives: shard ``g``'s block
    is ``100·g + [0, width)``; its reduce-scatter input is ``(size, width)``
    with chunk ``c`` ``100·g + 10·c + [0, width)``."""
    size = mesh.size(axis)
    g = torch.arange(mesh.start(axis), mesh.start(axis) + mesh.local(axis),
                     device=mesh.device, dtype=torch.float32)
    cols = torch.arange(width, device=mesh.device, dtype=torch.float32)
    blocks = 100.0 * g[:, None] + cols
    chunks = 100.0 * g[:, None, None] + 10.0 * torch.arange(
        size, device=mesh.device, dtype=torch.float32)[None, :, None] + cols
    return blocks, chunks


def rank_program(rank: int, world: int, inputs: str, out_dir: str, params: dict) -> None:
    """One rank of a sharded build and search (see the module docstring).

    ``inputs`` is an npz with ``x``, ``intervals``, ``qv``, ``qi`` and
    ``flags`` (and, for a two-axis search, the host arrays ``hx``, ``hi``,
    ``hn``, ``hs``, ``hg`` of every shard).  ``params``: ``device``,
    ``shards``, ``cfg`` (``UGConfig`` fields), ``ef``, ``k``, ``width``,
    ``ring_k``, ``threads`` (CPU threads; by default the host's cores
    split between the ranks) and ``mesh2`` (a ``(shape, axes)`` pair,
    optional)."""
    # processes that share a host share its cores: oversubscribed OpenMP
    # pools slow every rank down by orders of magnitude
    torch.set_num_threads(params.get("threads") or max(1, (os.cpu_count() or 1) // world))
    data = np.load(inputs)
    dev = params["device"]
    mesh = make_mesh((params["shards"],), ("data",), device=dev)
    sidx = build_sharded_store(mesh, data["x"], data["intervals"], UGConfig(**params["cfg"]))
    q = {name: torch.as_tensor(data[name], device=mesh.device) for name in ("qv", "qi", "flags")}
    search = dict(ef=params["ef"], k=params["k"], width=params["width"], mixed=True)
    ids, dist_ = make_sharded_search_fn(mesh, **search)(sidx, q["qv"], q["qi"], q["flags"])
    ring_i, ring_d = make_ring_knn_fn(mesh, k=params["ring_k"])(sidx.store.plane.data,
                                                               sidx.global_ids)
    blocks, chunks = collective_inputs(mesh, "data")
    _, gathered = ring_all_gather(blocks, mesh, "data")
    out = dict(nbrs=sidx.store.nbrs, status=sidx.store.status, gids=sidx.global_ids,
               ids=ids, dist=dist_, ring_ids=ring_i, ring_dist=ring_d,
               all_gather=gathered, reduce_scatter=ring_reduce_scatter(chunks, mesh, "data"))
    if params.get("mesh2"):
        shape, axes = params["mesh2"]
        mesh2 = make_mesh(shape, axes, device=dev)
        sidx2 = shard_index(mesh2, axes, *(data[a] for a in ("hx", "hi", "hn", "hs", "hg")))
        for hier in (True, False):
            fn = make_sharded_search_fn(mesh2, index_axes=axes, hierarchical=hier, **search)
            out[f"ids_hier{int(hier)}"], out[f"dist_hier{int(hier)}"] = fn(
                sidx2, q["qv"], q["qi"], q["flags"])
    np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz",
             **{name: t.cpu().numpy() for name, t in out.items()})


# ---------------------------------------------------------------------------
# The mesh half of training
# ---------------------------------------------------------------------------
def host_bits(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array of the same bits (bfloat16 as int16)."""
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def digest(t: torch.Tensor) -> str:
    """A fingerprint of a tensor's bits, computed where the tensor lies:
    its shape, dtype and three wrapping int64 sums over its bits (plain,
    weighted by position, weighted by a hash of position), so two tensors
    with the same fingerprint are equal but for a vanishing chance.  Exact
    integer sums do not depend on their order: the same bits give the
    same fingerprint on any device."""
    flat = t.detach().reshape(-1)
    if flat.dtype.itemsize == 2:
        bits = flat.view(torch.int16)
    elif flat.dtype.itemsize == 4:
        bits = flat.view(torch.int32)
    else:
        bits = flat.view(torch.int64) if flat.dtype.itemsize == 8 else flat.to(torch.int64)
    sums = torch.zeros(3, dtype=torch.int64, device=flat.device)
    step = 1 << 26
    for s in range(0, bits.numel(), step):
        b = bits[s:s + step].to(torch.int64)
        pos = torch.arange(s, s + b.numel(), dtype=torch.int64, device=b.device)
        mix = (pos * 0x5851F42D4C957F2D) ^ (pos >> 7)
        sums += torch.stack([b.sum(), (b * (pos + 1)).sum(), (b * mix).sum()])
    return f"{tuple(t.shape)} {t.dtype} " + " ".join(f"{int(v):x}" for v in sums.cpu())


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def run_mesh_train(model, mesh, full, batches: list, opt_kw: dict, *, microbatches: int = 1):
    """Donated mesh steps of ``model``, one a batch of ``batches``, from the
    whole parameters ``full`` (each leaf sharded to this process's block).
    Returns ``(blocks, opt_state, log)``: ``log`` holds each step's loss,
    ce, aux, grad norm and dropped assignments (MoE), its seconds and the
    seconds spent in its collectives, the bytes of the parameter and
    moment blocks this process holds, and each step's collective operand
    bytes by type (``distributed.collectives.COUNTS``)."""
    import time

    from repro_torch.distributed.collectives import counts, reset_counts
    from repro_torch.launch.shardings import shard_tree
    from repro_torch.train import AdamWConfig, make_train_step, optim

    blocks = shard_tree(full, mesh, model.specs(mesh))
    ocfg = AdamWConfig(**opt_kw)
    opt = optim.init(ocfg, blocks)
    step = make_train_step(model, ocfg, mesh, microbatches=microbatches, donate=True)
    step.timing = {}
    log = dict(loss=[], ce=[], aux=[], grad_norm=[], seconds=[], collective_seconds=[],
               collective_bytes=[], dropped=[])
    for batch in batches:
        step.timing.clear()
        _sync(mesh.device)
        reset_counts()
        t0 = time.perf_counter()
        blocks, opt, m = step(blocks, opt, batch)
        loss = float(m["loss"])
        _sync(mesh.device)
        log["seconds"].append(time.perf_counter() - t0)
        log["collective_seconds"].append(sum(step.timing.values()))
        log["collective_bytes"].append(counts())
        log["loss"].append(loss)
        log["grad_norm"].append(float(m["grad_norm"]))
        for key in ("ce", "aux", "dropped"):
            if key in m:
                log[key].append(float(m[key]))
    log["param_bytes"] = sum(t.numel() * t.element_size() for _, t in tree_leaves(blocks))
    log["moment_bytes"] = sum(t.numel() * t.element_size() for tree in (opt.m, opt.v)
                              for _, t in tree_leaves(tree))
    return blocks, opt, log


def run_ep_layer(cfg, mesh, layer, x, g):
    """The expert-parallel MoE layer under ``shard_ctx.use_mesh(mesh)``:
    forward of this process's block of ``x`` (the whole (B, S, d) on every
    process) with its blocks of ``layer`` (the layer's whole leaves), and
    backward of ``Σ y · g + aux``.  Returns the whole ``y``, ``aux``, the
    whole input gradient and the layer's whole gradients (gathered), the
    seconds of the forward and backward, the bytes the all-to-alls sent to
    other processes, the assignments the per-shard capacity dropped and
    the forward's and backward's collective operand bytes by type."""
    import time

    from repro_torch.distributed.collectives import counts, reset_counts

    from repro_torch.launch.shardings import gather_leaf, shard_leaf, shard_tree
    from repro_torch.models import moe, shard_ctx
    from repro_torch.models.common import ParamBuilder, tree_map

    spec_tree = moe.build_moe_params(cfg, ParamBuilder(cfg, "spec", mesh=mesh),
                                     prefix_layers=False)
    specs = dict(tree_leaves(spec_tree))
    dp = tuple(a for a in ("pod", "data") if a in mesh.axes)
    x_spec = P(dp or None, "model" if "model" in mesh.axes else None, None)
    p = tree_map(lambda t: t.requires_grad_(True), shard_tree(layer, mesh, spec_tree))
    blocks = dict(tree_leaves(p))
    xb = shard_leaf(x, mesh, x_spec).requires_grad_(True)
    gb = shard_leaf(g, mesh, x_spec)
    moe.EP_STATS.update(a2a_bytes_sent=0, dropped=0)
    _sync(mesh.device)
    reset_counts()
    t0 = time.perf_counter()
    with shard_ctx.use_mesh(mesh), torch.enable_grad():
        y, aux = moe.moe_ffn(cfg, p, xb)
        loss = torch.sum(y.float() * gb.float()) + aux
        leaves = [xb] + list(blocks.values())
        grads = torch.autograd.grad(loss, leaves)
    _sync(mesh.device)
    seconds = time.perf_counter() - t0
    collective_bytes = counts()
    out = dict(y=gather_leaf(y.detach(), mesh, x_spec), aux=aux.detach(),
               dx=gather_leaf(grads[0], mesh, x_spec))
    for (path, _), gr in zip(blocks.items(), grads[1:]):
        out["grad/" + "/".join(path)] = gather_leaf(gr, mesh, specs[path])
    return out, dict(seconds=seconds, all_to_all_bytes_sent=moe.EP_STATS["a2a_bytes_sent"],
                     dropped=moe.EP_STATS["dropped"], collective_bytes=collective_bytes)


def train_rank_program(rank: int, world: int, inputs: str | None, out_dir: str,
                       params: dict) -> None:
    """One rank of a list of jobs, each :func:`run_mesh_train` or
    :func:`run_ep_layer`, run in turn.

    ``params``: ``device``, ``threads``, ``save`` (``"arrays"`` or
    ``"digests"``) and ``jobs``, each a dict with a ``name`` and a ``kind``:

    * ``"train"``: ``arch``, ``reduced``, ``dtype``, ``mesh`` (the ``(data,
      model)`` shape), ``opt`` (``AdamWConfig`` fields), ``microbatches``,
      ``steps``; the whole initial parameters from the npz ``inputs``
      (``<name>/p/<path>``) or ``model.init`` on the device from ``seed``;
      the batches from the npz (``<name>/b<i>/<key>``, ``frames`` too for
      an encoder-decoder) or ``lm_batch`` of
      ``(vocab, batch, seq)`` at each step;
    * ``"ep"``: the layer's config (``cfg`` fields, or ``arch`` at full
      width with one layer), ``dtype``, ``mesh`` as ``(shape, axes)``; the
      layer, ``x`` and the cotangent ``g`` from the npz (``<name>/ep/<path>``,
      ``<name>/x``, ``<name>/g``) or drawn on the device from ``seed`` at
      ``(B, S)``.

    Rank 0 writes every job's gathered results to ``out_dir/rank0.npz``
    under ``<name>/`` (arrays as their bits, or one sha256 a leaf); every
    rank writes its logs to ``out_dir/rank{rank}.json``."""
    import dataclasses
    import json

    from repro_torch.configs import get_arch
    from repro_torch.data import LMDataConfig, lm_batch
    from repro_torch.kernels.util import resolve_device
    from repro_torch.launch.shardings import gather_tree
    from repro_torch.models import get_model, moe
    from repro_torch.models.common import ModelConfig, ParamBuilder
    from repro_torch.train.optim import tree_from_paths
    from repro_torch.train.step import deterministic

    torch.set_num_threads(params.get("threads") or max(1, (os.cpu_count() or 1) // world))
    dev = resolve_device(params["device"])
    data = np.load(inputs) if inputs else {}
    keys = set(data.keys()) if inputs else set()
    out, log = {}, {}

    def tensor(name):
        return torch.as_tensor(data[name]).to(dev)

    def subtree(prefix, template):
        return tree_from_paths(template, {path: tensor(prefix + "/".join(path))
                                          for path, _ in tree_leaves(template)})

    with deterministic(dev):
        for job in params["jobs"]:
            name = job["name"]
            dtype = getattr(torch, job.get("dtype", "float32"))
            if dev.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
            if job["kind"] == "train":
                spec = get_arch(job["arch"])
                cfg = dataclasses.replace(spec.reduced if job.get("reduced", True)
                                          else spec.config, dtype=dtype)
                model = get_model(cfg)
                mesh = make_mesh(job["mesh"], ("data", "model"), device=dev)
                if f"{name}/b0/tokens" in keys:
                    full = subtree(f"{name}/p/", model.shapes())
                    batches = [{k: tensor(f"{name}/b{i}/{k}")
                                for k in ("tokens", "labels", "mask", "frames")
                                if f"{name}/b{i}/{k}" in keys}
                               for i in range(job["steps"])]
                else:
                    full = model.init(torch.Generator(device=dev).manual_seed(job.get("seed", 0)))
                    dcfg = LMDataConfig(cfg.vocab, job["batch"], job["seq"])
                    batches = [lm_batch(dcfg, i, device=dev) for i in range(job["steps"])]
                blocks, opt, jlog = run_mesh_train(model, mesh, full, batches, job["opt"],
                                                   microbatches=job.get("microbatches", 1))
                del full
                specs = model.specs(mesh)
                jlog["block_shapes"] = {"/".join(path): list(t.shape)
                                        for path, t in tree_leaves(blocks)}
                kinds = (("p", blocks), ("m", opt.m), ("v", opt.v)) if job.get("moments", True) \
                    else (("p", blocks),)
                for kind, tree in kinds:
                    for path, leaf in tree_leaves(gather_tree(tree, mesh, specs)):
                        out[f"{name}/{kind}/" + "/".join(path)] = leaf
                del blocks, opt
            else:
                if "arch" in job:
                    cfg = dataclasses.replace(get_arch(job["arch"]).config, n_layers=1)
                else:
                    cfg = ModelConfig(**job["cfg"])
                cfg = dataclasses.replace(cfg, dtype=dtype)
                shape, axes = job["mesh"]
                mesh = make_mesh(shape, axes, device=dev)
                if f"{name}/x" in keys:
                    layer = subtree(f"{name}/ep/", moe.build_moe_params(
                        cfg, ParamBuilder(cfg, "shape"), prefix_layers=False))
                    x, g = tensor(f"{name}/x").to(dtype), tensor(f"{name}/g").to(dtype)
                else:
                    layer, x, g = ep_inputs(cfg, job["B"], job["S"], job.get("seed", 0), dev)
                res, jlog = run_ep_layer(cfg, mesh, layer, x, g)
                del layer
                for key, t in res.items():
                    out[f"{name}/{key}"] = t
            if dev.type == "cuda":
                jlog["peak_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
            log[name] = jlog
    if rank == 0:
        if params.get("save", "arrays") == "digests":
            arrays = {k: np.asarray(digest(t)) for k, t in out.items()}
        else:
            arrays = {k: host_bits(t) for k, t in out.items()}
        np.savez(pathlib.Path(out_dir) / "rank0.npz", **arrays)
    (pathlib.Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(log))


def tp_model(params: dict, dtype: str):
    """The model a tensor-parallel check runs: ``params["arch"]`` (its
    reduced config where ``params["reduced"]``) cut to ``params["layers"]``
    layers (an encoder-decoder's encoder to ``params["enc_layers"]``, else
    as many), in ``dtype``."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import get_model

    spec = get_arch(params["arch"])
    cfg = spec.reduced if params.get("reduced") else spec.config
    cut = dict(n_layers=params["layers"])
    if cfg.family == "encdec":
        cut["enc_layers"] = params.get("enc_layers", params["layers"])
    return get_model(dataclasses.replace(cfg, **cut, dtype=getattr(torch, dtype)))


def tp_batch(cfg, params: dict, step: int, dev) -> dict:
    """Step ``step``'s ``lm_batch`` of a tensor-parallel check: ``params
    ["batch"]`` rows of ``params["seq"]`` tokens, and for an
    encoder-decoder ``params["frames"]`` (default ``seq``) frames of
    ``d_model`` drawn from the same seed."""
    from repro_torch.data import LMDataConfig, lm_batch

    enc = cfg.family == "encdec"
    return lm_batch(LMDataConfig(cfg.vocab, params["batch"], params["seq"]), step,
                    frames_dim=cfg.d_model if enc else 0,
                    frames_len=params.get("frames", params["seq"]) if enc else 0, device=dev)


def tp_check_rank(rank: int, world: int, out_dir: str, params: dict) -> None:
    """One rank of a check of the tensor-parallel mesh step at an arch's
    full width, once a run of ``params["runs"]``: the donated mesh steps
    on ``params["mesh"]`` (``(data, model)``) from ``model.init`` at
    ``seed`` over the :func:`tp_batch` batches in the run's dtype, its peak
    memory over the first step (from the blocks and moments held); then the one-device
    step from the same weights on the first batch, its loss, grad norm and
    peak memory (from its parameters and moments held, less the blocks
    kept).  Where the run has ``params`` each rank keeps its blocks after
    the first step, runs the one-device step in turn and takes the largest
    ``|mesh − one device|`` over them; otherwise rank 0 alone runs it.
    Where the run has a ``reference`` (a file :func:`tp_reference` wrote
    before the ranks started: the card cannot hold the one-device step
    beside them) no rank runs it: each takes the largest error over the
    parameters the file holds, right after the first step, and the file's
    one-device numbers.

    ``params``: ``arch`` (its reduced config where ``reduced``), ``layers``
    (the depth it is cut to; ``enc_layers`` and ``frames`` for an
    encoder-decoder, :func:`tp_batch`), ``runs`` (``{"dtype": ..., "steps": ...,
    "params": bool, "reference": path (optional)}`` each, in order),
    ``mesh``, ``batch``, ``seq``, ``opt`` (``AdamWConfig`` fields),
    ``seed``, ``device``, ``threads``.  Writes ``out_dir/rank{rank}.json``:
    a record a run (its dtype, each step's loss, grad norm, aux and
    dropped assignments (MoE), seconds, collective phases' seconds
    (``gather_s``, ``tp_s``, ``reduce_s``) and collective operand bytes
    by type, the one-device step's loss, grad norm (and aux and dropped
    from a reference) and peak (rank 0's where the run has no ``params``;
    peaks ``None`` off the card), the bytes of the blocks held, the
    largest error or ``None``, and the leaves it was taken over), and the
    seconds from the program's start (``started_at``, wall clock) at which
    each part ended (``marks``)."""
    import json

    from repro_torch.distributed.collectives import counts, reset_counts
    from repro_torch.kernels.util import resolve_device
    from repro_torch.launch.shardings import shard_leaf, shard_tree
    from repro_torch.train import AdamWConfig, make_train_step, optim
    from repro_torch.train.step import deterministic

    start = time.perf_counter()
    log = dict(runs=[], marks={}, started_at=time.time())

    def mark(name):
        _sync(dev)
        log["marks"][name] = time.perf_counter() - start

    torch.set_num_threads(params.get("threads") or max(1, (os.cpu_count() or 1) // world))
    dev = resolve_device(params["device"])
    on_card = dev.type == "cuda"
    mark("device")
    mesh = make_mesh(params["mesh"], ("data", "model"), device=dev)
    ocfg = AdamWConfig(**params["opt"])

    def peak_from_here():
        if on_card:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)

    def held():
        return torch.cuda.memory_allocated(dev) if on_card else 0

    def peak(base):
        """The peak since ``peak_from_here``, less ``base`` bytes held before."""
        return torch.cuda.max_memory_allocated(dev) - base if on_card else None

    def free():
        if on_card:
            torch.cuda.empty_cache()

    def run(dtype: str, steps: int, compare: bool, reference=None) -> dict:
        model = tp_model(params, dtype)
        spec_of = dict(tree_leaves(model.specs(mesh)))
        init = lambda: model.init(torch.Generator(device=dev).manual_seed(params["seed"]))  # noqa: E731
        ref = torch.load(reference, map_location="cpu") if reference else None
        out = dict(dtype=dtype, loss=[], grad_norm=[], aux=[], dropped=[], seconds=[],
                   timing=[], collective_bytes=[])
        base = held()
        full = init()
        mark(f"{dtype}_init")
        blocks = shard_tree(full, mesh, model.specs(mesh))
        del full
        opt = optim.init(ocfg, blocks)
        mark(f"{dtype}_blocks")
        step = make_train_step(model, ocfg, mesh, donate=True)
        out["param_bytes"] = sum(t.numel() * t.element_size() for _, t in tree_leaves(blocks))
        first = {}
        for i in range(steps):
            batch = tp_batch(model.cfg, params, i, dev)
            step.timing = {}
            if i == 0:
                peak_from_here()
            _sync(dev)
            reset_counts()
            t0 = time.perf_counter()
            blocks, opt, m = step(blocks, opt, batch)
            out["loss"].append(float(m["loss"]))
            _sync(dev)
            out["seconds"].append(time.perf_counter() - t0)
            out["grad_norm"].append(float(m["grad_norm"]))
            for key in ("aux", "dropped"):
                if key in m:
                    out[key].append(float(m[key]))
            out["timing"].append(dict(step.timing))
            out["collective_bytes"].append(counts())
            if i == 0:
                out["peak_memory_allocated"] = peak(base)
                if ref is not None:
                    out["max_param_err"] = _max_err_kept(ref["params"], dict(tree_leaves(blocks)),
                                                         mesh, spec_of)
                    out["compared"] = sorted(ref["params"])
                elif compare:
                    first = {path: t.clone() for path, t in tree_leaves(blocks)}
        mark(f"{dtype}_mesh_steps")
        del blocks, opt, step, m
        free()
        if ref is not None:
            out.update({f"one_device_{k}": ref[k] for k in (
                "loss", "grad_norm", "aux", "dropped", "peak_memory_allocated")})
            return out
        out["max_param_err"] = None
        for r in range(world if compare else 1):    # one rank's one-device step at a time
            dist.barrier()
            if r != rank:
                continue
            base = held()                  # the blocks kept from the mesh step
            full = init()
            o1 = optim.init(ocfg, full)
            peak_from_here()
            full, o1, m1 = make_train_step(model, ocfg, donate=True)(
                full, o1, tp_batch(model.cfg, params, 0, dev))
            out["one_device_peak_memory_allocated"] = peak(base)
            out["one_device_loss"] = float(m1["loss"])
            out["one_device_grad_norm"] = float(m1["grad_norm"])
            mark(f"{dtype}_one_device_step")
            del o1
            if compare:
                out["max_param_err"] = max(
                    float((shard_leaf(t, mesh, spec_of[path]) - first[path]).abs().max())
                    for path, t in tree_leaves(full))
            del full
            free()
            mark(f"{dtype}_one_device_compared")
        dist.barrier()
        del first
        free()
        return out

    with deterministic(dev):
        for r in params["runs"]:
            log["runs"].append(run(r["dtype"], r["steps"], r["params"], r.get("reference")))
    mark("end")
    (pathlib.Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(log))


def tp_check_cells(rank: int, world: int, out_dir: str, cells: list) -> None:
    """:func:`tp_check_rank` of each of ``cells`` (its ``params``) in turn in
    one process group, cell ``i``'s records in ``out_dir/i`` (made by the
    caller): one start of the ranks for several archs."""
    for i, params in enumerate(cells):
        tp_check_rank(rank, world, str(pathlib.Path(out_dir) / str(i)), params)


def tp_check_all(cells: list, work, world: int = 2, timeout: float = 120.0) -> list[dict]:
    """Hold each of ``cells`` (:func:`tp_check_rank`'s ``params``) to its
    one-device steps: every run's :func:`tp_reference` first, alone in
    this process, then :func:`tp_check_cells` in ``world`` ranks forked
    from the server (:func:`start_forkserver`), over gloo.  ``work`` is a
    directory that does not exist yet.  Returns a record a cell: its
    ``params`` with each run's ``reference`` path, the one-device records
    (``references``, one a run, each with its ``wall_seconds``, the step's
    set-up and parameters kept included), each rank's log (``logs``) and the ranks' ``spawn_seconds``
    and wall-clock start (``wall``)."""
    import json

    work = pathlib.Path(work)
    out = []
    for i, params in enumerate(cells):
        (work / str(i)).mkdir(parents=True)
        runs = [dict(r, reference=str(work / str(i) / f"one_device_{j}.pt"))
                for j, r in enumerate(params["runs"])]
        params = dict(params, runs=runs)
        refs = []
        for r in runs:
            t0 = time.perf_counter()
            refs.append(dict(tp_reference(params, r, r["reference"]),
                             wall_seconds=time.perf_counter() - t0))
        out.append(dict(params=params, references=refs))
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    wall, t0 = time.time(), time.perf_counter()
    spawn_ranks(tp_check_cells, world, (str(work), [c["params"] for c in out]),
                init_file=work / "init", timeout=timeout, start="forkserver")
    for i, c in enumerate(out):
        c.update(logs=[json.loads((work / str(i) / f"rank{r}.json").read_text())
                       for r in range(world)],
                 spawn_seconds=time.perf_counter() - t0, wall=wall)
    return out


def _max_err_kept(kept: dict, blocks: dict, mesh, spec_of: dict) -> float:
    """The largest ``|block − kept|`` over the parameters :func:`tp_reference`
    kept (``{name: (dim, indices, values)}``: a whole leaf where ``dim`` is
    ``None``, else its ``indices`` along ``dim``), each compared where this
    process's block holds it."""
    from repro_torch.launch.shardings import shard_leaf

    err = 0.0
    for name, (dim, indices, values) in kept.items():
        path = tuple(name.split("/"))
        block, spec = blocks[path], spec_of[path]
        if dim is None:
            err = max(err, float((shard_leaf(values.to(block.device), mesh, spec)
                                  - block).abs().max()))
            continue
        # the kept indices along dim, the other dimensions cut as the block is
        kept_blk = shard_leaf(values.to(block.device), mesh,
                              P(*(None if i == dim else e for i, e in enumerate(spec))))
        n = block.shape[dim] // mesh.local("model")
        lo = mesh.start("model") * n
        for k, idx in enumerate(indices):
            if lo <= idx < lo + block.shape[dim]:
                err = max(err, float((block.select(dim, idx - lo)
                                      - kept_blk.select(dim, k)).abs().max()))
    return err


def tp_reference(params: dict, run: dict, path) -> dict:
    """The one-device step :func:`tp_check_rank` holds a run with a
    ``reference`` to, run in the calling process before the ranks start:
    from ``model.init`` at ``params["seed"]`` on :func:`tp_batch` 0 in the
    run's dtype, its loss, grad norm and aux, the assignments its dispatch
    drops (counted in a forward without gradients before it), its seconds
    and peak memory, and the parameters after it: each leaf of at most
    ``params["whole_max"]`` elements (default 2^26) whole, each larger one
    that the specs split along ``model`` at the first and last index of
    every ``model`` shard along that dimension (an expert leaf's first and
    last expert of each shard, the vocab leaves' first and last rows).
    Writes them to ``path`` (``torch.save``, on the host) and returns the
    record without the parameters.  Where ``params`` has ``perturb`` the
    step starts from the weights each scaled by ``1 + perturb · N(0, 1)``
    (a generator seeded from ``seed`` + 1): how far the step moves when
    its weights move by that much."""
    from repro_torch.kernels.util import resolve_device
    from repro_torch.models import moe
    from repro_torch.train import AdamWConfig, make_train_step, optim
    from repro_torch.train.step import deterministic

    dev = resolve_device(params["device"])
    on_card = dev.type == "cuda"
    model = tp_model(params, run["dtype"])
    cfg = model.cfg
    mesh = make_mesh(params["mesh"], ("data", "model"), device=dev)
    size = mesh.size("model")
    ocfg = AdamWConfig(**params["opt"])
    batch = tp_batch(cfg, params, 0, dev)
    if on_card:
        torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev) if on_card else 0
    full = model.init(torch.Generator(device=dev).manual_seed(params["seed"]))
    if params.get("perturb"):
        g = torch.Generator(device=dev).manual_seed(params["seed"] + 1)
        for _, t in tree_leaves(full):
            t.mul_(1 + params["perturb"] * torch.randn(t.shape, generator=g, dtype=t.dtype,
                                                       device=dev))
    routes, original = [], moe._router

    def recording(cfg_, xt, w):
        out = original(cfg_, xt, w)
        routes.append(out[0])
        return out

    moe._router = recording
    try:
        with torch.no_grad():
            model.loss(full, batch)
    finally:
        moe._router = original
    dropped = sum(moe.dropped_assignments(cfg, g) for g in routes)
    del routes
    opt = optim.init(ocfg, full)
    with deterministic(dev):
        if on_card:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        full, opt, m = make_train_step(model, ocfg, donate=True)(full, opt, batch)
        rec = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                   aux=float(m["aux"]), dropped=dropped, seconds=time.perf_counter() - t0,
                   peak_memory_allocated=(torch.cuda.max_memory_allocated(dev) - base
                                          if on_card else None))
    del opt
    whole_max = params.get("whole_max", 1 << 26)
    spec_of = dict(tree_leaves(model.specs(mesh)))
    kept = {}
    for p, t in tree_leaves(full):
        at = [i for i, e in enumerate(spec_of[p])
              if e == "model" or (isinstance(e, tuple) and "model" in e)]
        name = "/".join(p)
        if t.numel() <= whole_max or not at:
            kept[name] = (None, None, t.cpu())
            continue
        n = t.shape[at[0]] // size
        idx = sorted({i for s in range(size) for i in (s * n, s * n + n - 1)})
        kept[name] = (at[0], idx, t.index_select(at[0], torch.tensor(idx, device=t.device)).cpu())
    del full
    if on_card:
        torch.cuda.empty_cache()
    torch.save(dict(rec, params=kept), path)
    rec["kept"] = {name: (dim, idx) for name, (dim, idx, _) in kept.items()}
    return rec


def ep_inputs(cfg, B: int, S: int, seed: int, dev):
    """An MoE layer, a residual ``x`` (B, S, d) and a cotangent ``g`` drawn
    on ``dev`` from ``seed`` (the same on every process)."""
    from repro_torch.models import moe
    from repro_torch.models.common import ParamBuilder

    gen = torch.Generator(device=dev).manual_seed(seed)
    layer = moe.build_moe_params(cfg, ParamBuilder(cfg, "init", gen), prefix_layers=False)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=dev).to(cfg.dtype)
    g = torch.randn(x.shape, generator=gen, device=dev).to(cfg.dtype)
    return layer, x, g


# ---------------------------------------------------------------------------
# The decoders' split prefill and decode
# ---------------------------------------------------------------------------
def serve_inputs(cfg, params: dict, dev):
    """A serve check's inputs, drawn on the CPU from ``params["seed"]``:
    ``params["batch"]`` prompts of ``params["prompt"]`` tokens, the
    ``params["steps"]`` teacher-forced tokens of each decode step (the token
    at the row's position, ``(steps, B, 1)``) and the rows' lengths
    ``params["lens"]`` (each at most the prompt's: a row's decode steps
    overwrite its positions past its length)."""
    g = torch.Generator().manual_seed(params["seed"] + 1)
    B, P, steps = params["batch"], params["prompt"], params["steps"]
    tokens = torch.randint(0, cfg.vocab, (B, P + steps), generator=g, dtype=torch.int32)
    lens = torch.tensor(params["lens"], dtype=torch.int32)
    forced = torch.stack([tokens[torch.arange(B), (lens + i).long()][:, None]
                          for i in range(steps)])
    return tokens[:, :P].to(dev), forced.to(dev), lens.to(dev)


def _padded(caches, lens, S: int):
    """A decode state of ``S`` positions holding the prefill's ``caches``."""
    import torch.nn.functional as F

    from repro_torch.models.transformer import DecodeState

    return DecodeState(tuple(F.pad(c, (0, 0) * (c.ndim - 3) + (0, S - c.shape[2]))
                             for c in caches), lens.clone())


@torch.no_grad()
def serve_one_device(model, weights, prompts, forced, lens, S: int) -> dict:
    """The one-device prefill of ``prompts`` and the decode steps of
    ``forced`` against an ``S``-position cache from the rows' ``lens``:
    the prefill's last-position logits and caches, each step's logits and
    next token (the first largest logit), the last step's caches."""
    from repro_torch.models import transformer as tr

    hidden, caches = model.prefill(weights, {"tokens": prompts})
    out = dict(prefill_logits=tr.unembed(model.cfg, weights, hidden[:, -1:]),
               prefill_cache=caches, logits=[], next=[])
    state = _padded(caches, lens, S)
    for f in forced:
        state, logits = model.decode_step(weights, state, f)
        out["logits"].append(logits)
        out["next"].append(torch.argmax(logits, dim=-1).to(torch.int32)[:, None])
    out["cache"] = state.cache
    return out


def serve_split(model, mesh, blocks, prompts, forced, lens, S: int, log: dict | None = None
                ) -> dict:
    """:func:`serve_one_device` as the split serve step runs it on
    ``mesh`` (``launch/dryrun.py``'s ``prefill_step``, then ``serve_step``
    a step), from this process's parameter ``blocks`` and its rows of the
    inputs; returns its blocks of the same outputs.  The prefill's cache
    blocks (a ``P``-position cache's) are re-cut into the ``S``-position
    decode state's (gathered whole, padded, cut): a check
    program's step, outside the serve step.  ``log`` collects the prefill's
    and each decode step's seconds, model-axis seconds (``tp_s``) and
    collective operand bytes by type."""
    import time

    from repro_torch.distributed.collectives import counts, reset_counts
    from repro_torch.launch.dryrun import _global_rows, prefill_step, serve_step
    from repro_torch.launch.shardings import decode_state_specs, gather_tree, shard_tree

    cfg, dev = model.cfg, mesh.device
    B, P = _global_rows(mesh, prompts.shape[0]), prompts.shape[1]
    log = {} if log is None else log
    log.update(seconds=[], tp_s=[], collective_bytes=[])

    def timed(fn):
        timing = {}
        _sync(dev)
        reset_counts()
        t0 = time.perf_counter()
        res = fn(timing)
        _sync(dev)
        log["seconds"].append(time.perf_counter() - t0)
        log["tp_s"].append(timing.get("tp_s", 0.0))
        log["collective_bytes"].append(counts())
        return res

    logits, caches = timed(lambda t: prefill_step(model, mesh, blocks, {"tokens": prompts},
                                                  timing=t))
    out = dict(prefill_logits=logits, prefill_cache=caches, logits=[], next=[])
    whole = _padded(gather_tree(caches, mesh, decode_state_specs(cfg, mesh, B, P).cache),
                    lens, S)
    state = type(whole)(shard_tree(whole.cache, mesh, decode_state_specs(cfg, mesh, B, S).cache),
                        lens)
    del whole
    for f in forced:
        state, nxt, lg = timed(lambda t, st=state, f=f: serve_step(
            model, mesh, blocks, st, f, timing=t, return_logits=True))
        out["logits"].append(lg)
        out["next"].append(nxt)
    out["cache"] = state.cache
    return out


def _on_host(out: dict) -> dict:
    return {k: ([t.cpu() for t in v] if isinstance(v, (list, tuple)) else v.cpu())
            for k, v in out.items()}


def serve_reference(params: dict, path, *, perturb: float | None = None) -> dict:
    """A serve check's one-device run (:func:`serve_one_device`), in the
    calling process before the ranks start: from ``model.init`` at
    ``params["seed"]`` (each weight scaled by ``1 + perturb · N(0, 1)`` where
    ``perturb`` is given, a generator seeded from ``seed`` + 1), its outputs
    written to ``path`` on the host; returns its seconds and its peak memory
    (the weights held included; ``None`` off the card)."""
    import time

    from repro_torch.kernels.util import resolve_device

    dev = resolve_device(params["device"])
    model = tp_model(params, params["dtype"])
    weights = model.init(torch.Generator(device=dev).manual_seed(params["seed"]))
    if perturb:
        g = torch.Generator(device=dev).manual_seed(params["seed"] + 1)
        for _, t in tree_leaves(weights):
            t.mul_(1 + perturb * torch.randn(t.shape, generator=g, dtype=t.dtype, device=dev))
    prompts, forced, lens = serve_inputs(model.cfg, params, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = serve_one_device(model, weights, prompts, forced, lens, params["cache"])
    _sync(dev)
    rec = dict(seconds=time.perf_counter() - t0,
               peak_memory_allocated=(torch.cuda.max_memory_allocated(dev)
                                      if dev.type == "cuda" else None))
    torch.save(_on_host(out), path)
    del weights, out
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def _serve_run(params: dict, mesh, log: dict) -> dict:
    """:func:`serve_split` of a serve check on ``mesh``: the weights drawn
    whole and cut to this process's blocks, its rows of the inputs; its
    peak memory from the blocks held on (``None`` off the card)."""
    from repro_torch.launch.shardings import batch_shardings, shard_leaf, shard_tree

    dev = mesh.device
    model = tp_model(params, params["dtype"])
    full = model.init(torch.Generator(device=dev).manual_seed(params["seed"]))
    blocks = shard_tree(full, mesh, model.specs(mesh))
    del full
    bspec = batch_shardings(mesh).spec
    prompts, forced, lens = serve_inputs(model.cfg, params, dev)
    prompts, lens = shard_leaf(prompts, mesh, bspec), shard_leaf(lens, mesh, bspec)
    forced = torch.stack([shard_leaf(f, mesh, bspec) for f in forced])
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    out = serve_split(model, mesh, blocks, prompts, forced, lens, params["cache"], log)
    log["peak_memory_allocated"] = (torch.cuda.max_memory_allocated(dev)
                                    if dev.type == "cuda" else None)
    log["param_bytes"] = sum(t.numel() * t.element_size() for _, t in tree_leaves(blocks))
    return out


def serve_check_rank(rank: int, world: int, out_dir: str, cells: list) -> None:
    """One rank of :func:`serve_check_all`: each cell's split run
    (:func:`_serve_run`) on its mesh in turn, its blocks of the outputs to
    ``out_dir/i/rank{rank}.pt`` and its log to ``out_dir/i/rank{rank}.json``
    for cell ``i``."""
    import json

    from repro_torch.kernels.util import resolve_device

    for i, params in enumerate(cells):
        torch.set_num_threads(params.get("threads") or max(1, (os.cpu_count() or 1) // world))
        dev = resolve_device(params["device"])
        mesh = make_mesh(params["mesh"], ("data", "model"), device=dev)
        log = {}
        out = _serve_run(params, mesh, log)
        work = pathlib.Path(out_dir) / str(i)
        torch.save(_on_host(out), work / f"rank{rank}.pt")
        (work / f"rank{rank}.json").write_text(json.dumps(log))
        del out
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def _rel(got, want) -> float:
    """``max |got − want| / max |want|`` over the tensors of two lists."""
    num = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
    return num / max(float(w.double().abs().max()) for w in want)


def _serve_parts(out: dict) -> dict:
    """A serve run's outputs in the groups a check compares."""
    return dict(prefill_logits=[out["prefill_logits"]], prefill_cache=list(out["prefill_cache"]),
                logits=list(out["logits"]), cache=list(out["cache"]))


def _serve_specs(model, mesh, params: dict) -> dict:
    """Each output's spec (as :func:`_serve_parts` groups them) on ``mesh``:
    the rows along the data axes, the logits' vocab columns along ``model``
    where the vocab splits, the caches by ``decode_state_specs``."""
    from repro_torch.launch.shardings import decode_state_specs
    from repro_torch.models.common import P

    cfg, B = model.cfg, params["batch"]
    spec_of = dict(tree_leaves(model.specs(mesh)))
    vocab = spec_of[("embed",)][0] if cfg.tie_embeddings else spec_of[("unembed",)][1]
    cache = list(decode_state_specs(cfg, mesh, B, params["cache"]).cache)
    rows = cache[0][1]
    return dict(prefill_logits=[P(rows, None, vocab)],
                prefill_cache=list(decode_state_specs(cfg, mesh, B, params["prompt"]).cache),
                logits=[P(rows, vocab)] * params["steps"], cache=cache,
                next=[P(rows, None)] * params["steps"])


def serve_check_all(cells: list, work, world: int = 2, timeout: float = 120.0,
                    start: str = "forkserver") -> list[dict]:
    """Hold each of ``cells`` (a serve check's ``params``: ``arch``,
    ``reduced``, ``layers``, ``dtype``, ``mesh``, ``batch``, ``prompt``,
    ``cache``, ``steps``, ``lens``, ``seed``, ``device``, ``threads``) to its
    one-device run.  In this process first, for each cell: the one-device
    run (:func:`serve_reference`) and the split run with every shard in
    this one process; then :func:`serve_check_rank` in ``world`` ranks over
    gloo (forked from the server, :func:`start_forkserver`, or spawned).
    ``work`` is a directory that does not exist yet.  Returns a record a
    cell: its ``params``; the largest ``max |split − one device| / max
    |one device|`` over the ranks of the prefill's logits and caches, the
    decode steps' logits and the last caches (``rel``); whether every
    rank's next tokens equal the one-device run's (``next_equal``), whether
    every rank's blocks equal the one-process split run's bit for bit
    (``bitwise_one_process``); each rank's log (:func:`serve_split`'s, with
    its peak memory and parameter bytes), the one-device run's record
    (``one_device``), the one-process run's log, and the ranks' seconds
    (``spawn_seconds``).  The one-device run routes an MoE layer's rows as
    one group, as the split does only where ``data`` has one shard."""
    import json
    import time

    from repro_torch.launch.mesh import Mesh, _process_grid
    from repro_torch.launch.shardings import shard_leaf

    work = pathlib.Path(work)
    refs, ones = [], []
    for i, params in enumerate(cells):
        (work / str(i)).mkdir(parents=True)
        refs.append(serve_reference(params, work / str(i) / "one_device.pt"))
        mesh = make_mesh(params["mesh"], ("data", "model"), device=params["device"])
        log = {}
        torch.save(_on_host(_serve_run(params, mesh, log)), work / str(i) / "one_process.pt")
        ones.append(log)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spawn_ranks(serve_check_rank, world, (str(work), cells), init_file=work / "init",
                timeout=timeout, start=start)
    spawn_s = time.perf_counter() - t0
    out = []
    for i, params in enumerate(cells):
        model = tp_model(params, params["dtype"])
        one = torch.load(work / str(i) / "one_device.pt")
        single = torch.load(work / str(i) / "one_process.pt")
        procs = _process_grid(params["mesh"], world)
        rel = {k: 0.0 for k in ("prefill_logits", "prefill_cache", "logits", "cache")}
        next_equal, bitwise, logs = True, True, []
        for r in range(world):
            coords = tuple(int(c) for c in np.unravel_index(r, procs))
            mesh = Mesh(tuple(params["mesh"]), ("data", "model"), torch.device("cpu"), procs,
                        coords, {})
            got = torch.load(work / str(i) / f"rank{r}.pt")
            specs = _serve_specs(model, mesh, params)
            cut = lambda whole, key: [shard_leaf(t, mesh, sp)   # noqa: E731
                                      for t, sp in zip(whole, specs[key])]
            for k, parts in _serve_parts(got).items():
                rel[k] = max(rel[k], _rel(parts, cut(_serve_parts(one)[k], k)))
                bitwise &= all(torch.equal(a, b) for a, b in
                               zip(parts, cut(_serve_parts(single)[k], k)))
            next_equal &= all(torch.equal(a, b) for a, b in zip(got["next"],
                                                               cut(one["next"], "next")))
            bitwise &= all(torch.equal(a, b) for a, b in zip(got["next"],
                                                             cut(single["next"], "next")))
            logs.append(json.loads((work / str(i) / f"rank{r}.json").read_text()))
        out.append(dict(params=params, rel=rel, next_equal=next_equal,
                        bitwise_one_process=bitwise, logs=logs, one_device=refs[i],
                        one_process=ones[i], spawn_seconds=spawn_s))
    return out
