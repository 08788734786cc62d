"""Checkpoints: one directory a step, written atomically, old steps pruned.

Layout, byte-compatible with the reference's ``ckpt/store.py`` in both
directions::

    <dir>/step_000000123/
        manifest.json     # step, data cursor, time, keys (file, dtype, shape), extra
        arrays/<key>.npy  # one file a leaf, "/" in the key written as "__"

A step is written into ``.tmp_step_<step>`` and renamed.  Leaves are named
as ``jax.tree_util`` names them: a dict's entries in sorted key order, by
key; a list's or tuple's by index; a NamedTuple's by field name; ``None`` is
an empty subtree.  So a checkpoint of nested numpy arrays or tensors written
by either package restores in the other.  Leaves are saved as full logical
arrays.  :func:`restore` places them on ``device``, or, given target
shardings (``NamedSharding`` trees, as the reference's ``restore`` takes
them), places this process's block of each leaf under its sharding's mesh
(``launch.shardings.shard_leaf``): a checkpoint written on one mesh
restores onto another (``ft.elastic.resume``).  :func:`save` from a mesh
takes the parameters' and moments' shardings: every process gathers each
leaf in turn, one leaf at a time, and one process (rank 0, or the only one)
writes it, so the files are those a one-device save of the same
parameters writes, byte for byte.

:func:`save_index`/:func:`restore_index` checkpoint a (possibly mutated)
:class:`~repro_torch.core.index.UGIndex`: the store's arrays under
``params/``, the build config, plane tag and allocator flags in ``extra``,
as the reference writes them (``prune_backend`` under the reference's
name).  :class:`AsyncCheckpointer` copies to the host at once and writes on
a background thread.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core.index import (
    UGIndex, host_arrays, loaded_config, saved_config, store_from_arrays,
)
from repro_torch.kernels.util import resolve_device
from repro_torch.launch.mesh import is_rank0

_SEP = "/"


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _children(tree) -> list[tuple[str, Any]] | None:
    """``(name, child)`` pairs of a container in ``jax.tree_util``'s order,
    or ``None`` for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(tree)]
    return None


def _map(fn, tree, path: str = ""):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``, the paths
    ``/``-joined; ``None`` holds no leaf."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(path, tree)
    out = {name: _map(fn, child, f"{path}{_SEP}{name}" if path else name)
           for name, child in kids}
    if isinstance(tree, dict):
        return {k: out[str(k)] for k in tree}
    vals = [out[name] for name, _ in kids]
    return type(tree)(*vals) if _is_namedtuple(tree) else type(tree)(vals)


def _flatten(tree) -> dict[str, Any]:
    """Leaves by path, in ``jax.tree_util``'s order."""
    flat = {}
    _map(lambda path, leaf: flat.__setitem__(path, leaf), tree)
    return flat


def _host(leaf):
    """A leaf on the host: a numpy array, or a CPU tensor for bfloat16,
    which numpy has no type for."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        return leaf if leaf.dtype == torch.bfloat16 else leaf.numpy()
    return np.asarray(leaf)


def _save_leaf(path: pathlib.Path, leaf) -> tuple[str, list[int]]:
    """Write one leaf as ``.npy``; returns its manifest dtype and shape.

    A bfloat16 leaf is written as the reference writes one (numpy saves
    ``ml_dtypes.bfloat16`` as 2-byte words under the descr ``<V2``), with
    the dtype ``"bfloat16"`` in the manifest: the same bytes."""
    arr = _host(leaf)
    if isinstance(arr, torch.Tensor):                  # bfloat16
        words = arr.contiguous().view(torch.int16).numpy()
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False, "shape": words.shape})
            f.write(words.tobytes())
        return "bfloat16", list(words.shape)
    np.save(path, arr)
    return str(arr.dtype), list(arr.shape)


def _load_leaf(path: pathlib.Path, dtype: str) -> torch.Tensor:
    """One leaf as a CPU tensor, read by its manifest dtype: a bfloat16
    leaf's 2-byte words (``np.load`` gives them as void ``|V2``) become a
    ``torch.bfloat16`` tensor."""
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.as_tensor(arr)


def _step_dir(root: pathlib.Path, step: int, tmp: bool = False) -> pathlib.Path:
    return root / (f".tmp_step_{step:09d}" if tmp else f"step_{step:09d}")


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def _gathered(tree, shardings, prefix: str):
    """``tree`` with each leaf that has a sharding in ``shardings`` (same
    structure, a prefix allowed: ``None`` places nothing) replaced by a
    function that gathers the whole leaf (collective), the others by their
    leaf."""
    from repro_torch.launch.shardings import gather_leaf

    shard_of = _flatten(shardings) if shardings is not None else {}

    def leaf(path, t):
        sh = shard_of.get(path)
        if sh is None:
            return t
        return lambda: gather_leaf(t, sh.mesh, sh.spec)

    return _map(leaf, tree)


def save(
    ckpt_dir: str | pathlib.Path,
    step: int,
    params,
    opt_state=None,
    *,
    data_cursor: int = 0,
    extra: dict | None = None,
    keep: int = 3,
    param_shardings=None,
    opt_shardings=None,
) -> pathlib.Path:
    """Write one checkpoint; prune old steps beyond ``keep``.  With
    shardings (the parameters' blocks held over a mesh), every process
    calls this: each leaf is gathered in turn and rank 0 writes it."""
    root = pathlib.Path(ckpt_dir)
    out = _step_dir(root, step)
    tmp = _step_dir(root, step, tmp=True)
    placed = param_shardings is not None or opt_shardings is not None
    writer = is_rank0() or not placed
    tree = {"params": _gathered(params, param_shardings, "params")}
    if opt_state is not None:
        tree["opt"] = _gathered(opt_state, opt_shardings, "opt")
    if not writer:
        for leaf in _flatten(tree).values():
            if callable(leaf):
                leaf()
        _barrier()
        return out
    if tmp.exists():
        shutil.rmtree(tmp)
    (tmp / "arrays").mkdir(parents=True)
    meta = {
        "step": step,
        "data_cursor": data_cursor,
        "time": time.time(),
        "keys": {},
        "extra": extra or {},
    }
    for key, leaf in _flatten(tree).items():
        fname = key.replace(_SEP, "__") + ".npy"
        dtype, shape = _save_leaf(tmp / "arrays" / fname, leaf() if callable(leaf) else leaf)
        meta["keys"][key] = {"file": fname, "dtype": dtype, "shape": shape}
    (tmp / "manifest.json").write_text(json.dumps(meta))
    if out.exists():
        shutil.rmtree(out)
    tmp.rename(out)

    steps = sorted(p for p in root.glob("step_*") if p.is_dir())
    for old in steps[:-keep]:
        shutil.rmtree(old, ignore_errors=True)
    if placed:
        _barrier()
    return out


def latest_step(ckpt_dir: str | pathlib.Path) -> int | None:
    root = pathlib.Path(ckpt_dir)
    steps = sorted(p.name for p in root.glob("step_*") if p.is_dir())
    return int(steps[-1].split("_")[1]) if steps else None


def _open(ckpt_dir, step: int | None) -> tuple[pathlib.Path, dict]:
    root = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    src = _step_dir(root, step)
    return src, json.loads((src / "manifest.json").read_text())


def restore(
    ckpt_dir: str | pathlib.Path,
    step: int | None = None,
    *,
    params_template=None,
    opt_template=None,
    param_shardings=None,
    opt_shardings=None,
    device=None,
):
    """Load a checkpoint (the latest step by default); optionally re-shard
    it onto a (possibly new) mesh.

    The templates give the trees' structure; the shardings (same
    structure, a prefix allowed) give placement: a leaf with a sharding
    comes back as this process's block under it, on its mesh's device;
    every other leaf as the whole tensor on ``device`` (``None`` = the
    card).  A bfloat16 leaf (either package's) comes back as a
    ``torch.bfloat16`` tensor.  Returns ``(params, opt_state, meta)``; a
    tree without a template is ``None``."""
    from repro_torch.launch.shardings import shard_leaf

    src, meta = _open(ckpt_dir, step)
    dev = None

    def rebuild(template, prefix, shardings):
        nonlocal dev
        if template is None:
            return None
        shard_of = _flatten(shardings) if shardings is not None else {}

        def leaf(path, _):
            nonlocal dev
            info = meta["keys"][f"{prefix}{_SEP}{path}" if path else prefix]
            arr = _load_leaf(src / "arrays" / info["file"], info["dtype"])
            sh = shard_of.get(path)
            if sh is not None:
                return shard_leaf(arr, sh.mesh, sh.spec).to(sh.mesh.device)
            if dev is None:
                dev = resolve_device(device)
            return arr.to(dev)

        return _map(leaf, template)

    return (rebuild(params_template, "params", param_shardings),
            rebuild(opt_template, "opt", opt_shardings), meta)


# ------------------------------------------------------------------ indexes
def index_tree(index: UGIndex) -> tuple[dict, dict]:
    """``(arrays, extra)`` that :func:`save_index` checkpoints: the store's
    host arrays and the reference's ``extra`` record."""
    st = index.store
    extra = {
        "kind": "ug_index",
        "config": saved_config(index.config),
        "build_seconds": index.build_seconds,
        "streaming": st.alive is not None,
        "dtype": st.plane.tag,
        "has_rerank": st.rerank is not None,
    }
    return host_arrays(st), extra


def save_index(ckpt_dir: str | pathlib.Path, step: int, index: UGIndex) -> pathlib.Path:
    """Checkpoint a (possibly mutated) UGIndex through :func:`save`: the
    store's arrays become leaves under ``params/``, the build config, plane
    tag and allocator flags ride in ``extra``.  A mutated index's
    ``alive``/``free`` are saved, so the restored index resumes inserts and
    deletes where the saved one stopped; int8 and pq parameters round-trip
    bit for bit."""
    arrays, extra = index_tree(index)
    return save(ckpt_dir, step, arrays, extra=extra)


def restore_index(ckpt_dir: str | pathlib.Path, step: int | None = None, *,
                  device=None) -> UGIndex:
    """Restore a UGIndex written by :func:`save_index` (either package's)
    onto ``device`` (``None`` = the card).  The entry structure is rebuilt
    from the restored intervals over the restored ``alive`` mask, so the
    restored index searches bit for bit like the saved one."""
    dev = resolve_device(device)
    src, meta = _open(ckpt_dir, step)
    extra = meta["extra"]
    if extra.get("kind") != "ug_index":
        raise ValueError(f"checkpoint at {src} is not a ug_index checkpoint")
    arrays = {key.split(_SEP, 1)[1]: np.load(src / "arrays" / info["file"])
              for key, info in meta["keys"].items() if key.startswith("params" + _SEP)}
    store = store_from_arrays(arrays, extra.get("dtype", "f32"), dev)
    return UGIndex(store, loaded_config(extra["config"]), extra.get("build_seconds", 0.0))


class AsyncCheckpointer:
    """Background-thread checkpointing.

    ``save`` copies the trees to host memory at once and writes the files on
    a worker thread; ``wait`` joins it, and every ``save`` waits for the
    previous write first, so at most one write is in flight.  A failed
    write raises from the next ``wait``."""

    def __init__(self, ckpt_dir: str | pathlib.Path, keep: int = 3):
        self.ckpt_dir = pathlib.Path(ckpt_dir)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self.last_path: pathlib.Path | None = None

    def save(self, step: int, params, opt_state=None, *, param_shardings=None,
             opt_shardings=None, **kw) -> None:
        """With shardings, every process calls this: the leaves are
        gathered to the host here, and rank 0 writes them."""
        self.wait()

        def host(_, leaf):
            return _host(leaf() if callable(leaf) else leaf)

        host_params = _map(host, _gathered(params, param_shardings, "params"))
        host_opt = _map(host, _gathered(opt_state, opt_shardings, "opt"))
        if (param_shardings is not None or opt_shardings is not None) and not is_rank0():
            self.last_path = _step_dir(self.ckpt_dir, step)
            return

        def work():
            try:
                self.last_path = save(self.ckpt_dir, step, host_params, host_opt,
                                      keep=self.keep, **kw)
            except Exception as e:  # noqa: BLE001  (re-raised by wait())
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
