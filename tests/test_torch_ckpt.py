"""The port's checkpoint store against the reference's, on the CPU, in both
directions.

Index checkpoints: a port index on integer-valued vectors (|v| ≤ 4, d = 8,
n = 300) re-encoded to each plane (f32, bf16, int8 + rerank, pq + rerank),
then mutated (30 ids deleted with repair, 40 rows inserted: the store
grows), is checkpointed by the port and restored by the reference; the
reference's own copy of the same index (read from the npz bridge) is
checkpointed by the reference and restored by the port.  Each side holds
the other's store tensors, ``alive``/``free`` and
``extra.config.prune_backend`` as it expects them, and its search on the
other's checkpoint equals the search on the original, bit for bit.

Generic trees: nested dicts, lists, tuples and NamedTuples of numpy arrays
give the same manifest keys, the same files byte for byte and the same
arrays in both directions, with ``keep`` pruning, ``latest_step`` and
``data_cursor``; ``AsyncCheckpointer`` writes what ``save`` writes.
"""
import collections
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import store as ref_ckpt
from repro.core import Semantics as RefSem
from repro.core import UGIndex as RefIndex
from repro_torch import ckpt
from repro_torch.core import Semantics, UGConfig, UGIndex

CYCLE = [Semantics.IF, Semantics.IS, Semantics.RS, Semantics.RF]
EXACT_CFG = dict(ef_spatial=12, ef_attribute=24, max_edges_if=10, max_edges_is=10,
                 iterations=2, repair_width=8, exact_spatial=True, block=128)
N, D = 300, 8
PLANES = [("f32", False), ("bf16", False), ("int8", True), ("pq", True)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small shapes: torch's intra-op pool would only contend with the other
    test processes and the reference's XLA threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        a = a.numpy()
    else:
        a = np.asarray(a)
        a = a.view(np.int16) if str(a.dtype) == "bfloat16" else a
    return a.view(np.int32) if a.dtype == np.float32 else a


def store_arrays(store) -> dict:
    out = dict(x=store.plane.data, intervals=store.intervals, nbrs=store.nbrs,
               status=store.status, alive=store.alive, free=store.free,
               x_scale=store.plane.scale, x_zero=store.plane.zero,
               x_codebooks=store.plane.codebooks,
               rerank=None if store.rerank is None else store.rerank.data)
    return {k: v for k, v in out.items() if v is not None}


def assert_same_store(a, b):
    sa, sb = store_arrays(a.store), store_arrays(b.store)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert tuple(sa[k].shape) == tuple(sb[k].shape), k
        assert np.array_equal(bits(sa[k]), bits(sb[k])), k
    assert a.dtype == b.dtype and a.capacity == b.capacity and int(a.n) == int(b.n)


def queries(rng, nq=32):
    qv = rng.integers(-4, 5, (nq, D)).astype(np.float32)
    c = rng.uniform(size=(nq, 1)).astype(np.float32)
    sems = [CYCLE[i % 4] for i in rng.permutation(nq)]
    half = np.array([[0.0 if s is Semantics.RS else 0.3] for s in sems], np.float32)
    return qv, np.concatenate([np.maximum(c - half, 0), np.minimum(c + half, 1)], 1), sems


def port_search(index, q):
    qv, qi, sems = q
    return index.search_mixed(qv, qi, sems, ef=32, k=10)


def ref_search(index, q):
    qv, qi, sems = q
    return index.search_mixed(jnp.asarray(qv), jnp.asarray(qi), [RefSem(s.value) for s in sems],
                              ef=32, k=10, backend="xla")


def assert_same_result(got, want):
    for a, b in ((got.ids, want.ids), (got.dist, want.dist), (got.steps, want.steps)):
        assert np.array_equal(bits(a), bits(b))
    assert int(got.iters) == int(want.iters)


@pytest.fixture(scope="module")
def mutated(tmp_path_factory):
    """Per plane: the port's mutated index and the reference's copy of it
    (read through the npz bridge)."""
    rng = np.random.default_rng(9)
    x = rng.integers(-4, 5, (N, D)).astype(np.float32)
    ints = np.sort(rng.uniform(size=(N, 2)), axis=-1).astype(np.float32)
    base = UGIndex.build(x, ints, UGConfig(**EXACT_CFG, prune_backend="torch"), device="cpu")
    dels = rng.choice(N, 30, replace=False).astype(np.int32)
    new_x = rng.integers(-4, 5, (40, D)).astype(np.float32)
    new_iv = np.sort(rng.uniform(size=(40, 2)), axis=-1).astype(np.float32)
    out = {}
    for tag, rerank in PLANES:
        port = base.with_dtype(tag, rerank=rerank).delete(dels).insert(new_x, new_iv)
        path = tmp_path_factory.mktemp(f"npz_{tag}")
        port.save(path)
        out[tag] = (port, RefIndex.load(path))
    return out, queries(rng)


@pytest.mark.parametrize("tag", [t for t, _ in PLANES])
def test_port_checkpoint_restores_in_reference(mutated, tag, tmp_path):
    (port, ref_own), q = mutated[0][tag], mutated[1]
    path = ckpt.save_index(tmp_path, 7, port)
    assert path.name == "step_000000007"
    meta = json.loads((path / "manifest.json").read_text())
    assert meta["extra"]["config"]["prune_backend"] == "xla"
    restored = ref_ckpt.restore_index(tmp_path)
    assert restored.config.prune_backend == "xla"
    assert_same_store(port, restored)
    assert_same_store(ref_own, restored)
    assert_same_result(port_search(port, q), ref_search(restored, q))


@pytest.mark.parametrize("tag", [t for t, _ in PLANES])
def test_reference_checkpoint_restores_in_port(mutated, tag, tmp_path):
    (port_own, ref), q = mutated[0][tag], mutated[1]
    ref_ckpt.save_index(tmp_path, 3, ref)
    restored = ckpt.restore_index(tmp_path, device="cpu")
    assert restored.config.prune_backend == "torch"
    assert restored.config == port_own.config
    assert_same_store(restored, ref)
    entry = restored.entry.arrays()
    assert all(torch.equal(a, b) for a, b in zip(entry, port_own.entry.arrays()))
    assert_same_result(port_search(restored, q), ref_search(ref, q))


def test_index_round_trip_and_async_checkpointer(mutated, tmp_path):
    """The port's own round trip keeps every tensor and the answers; the
    async writer writes the same arrays and manifest keys; a non-index
    checkpoint is refused."""
    from repro_torch.ckpt.store import index_tree

    (port, _), q = mutated[0]["int8"], mutated[1]
    ckpt.save_index(tmp_path / "sync", 1, port)
    back = ckpt.restore_index(tmp_path / "sync", device="cpu")
    assert_same_store(port, back)
    assert_same_result(port_search(port, q), port_search(back, q))
    saver = ckpt.AsyncCheckpointer(tmp_path / "async")
    arrays, extra = index_tree(port)
    saver.save(1, arrays, extra=extra)
    saver.wait()
    assert_same_files(tmp_path / "sync" / "step_000000001", saver.last_path)
    ckpt.save(tmp_path / "plain", 0, {"w": np.ones(3)})
    with pytest.raises(ValueError, match="not a ug_index"):
        ckpt.restore_index(tmp_path / "plain", device="cpu")
    with pytest.raises(FileNotFoundError):
        ckpt.restore_index(tmp_path / "empty", device="cpu")


# ------------------------------------------------------------ generic trees
NT = collections.namedtuple("NT", ["y", "x"])


def make_tree(rng):
    params = {
        "layers": [{"w": rng.normal(size=(3, 4)).astype(np.float32),
                    "b": np.arange(4, dtype=np.int32)},
                   (rng.integers(0, 255, (5,)).astype(np.uint8),
                    NT(y=np.array([True, False]), x=rng.normal(size=(2, 2)).astype(np.float32))),
                   None],
        "embed": rng.integers(-8, 8, (6, 2)).astype(np.int8),
        "scale": np.float32(0.5),
    }
    opt = {"mu": [rng.normal(size=(2,)).astype(np.float32)],
           "count": np.array(3, np.int32), "codes": np.arange(5, dtype=np.uint16)}
    return params, opt


def assert_same_files(a, b):
    ma = json.loads((a / "manifest.json").read_text())
    mb = json.loads((b / "manifest.json").read_text())
    assert list(ma["keys"]) == list(mb["keys"])
    assert ma["keys"] == mb["keys"]
    assert {k: v for k, v in ma.items() if k != "time"} == {
        k: v for k, v in mb.items() if k != "time"}
    for info in ma["keys"].values():
        f = pathlib.Path("arrays") / info["file"]
        assert (a / f).read_bytes() == (b / f).read_bytes()


def assert_same_tree(got, want):
    gl = ckpt.store._flatten(got)
    wl = ckpt.store._flatten(want)
    assert list(gl) == list(wl)
    for k in gl:
        g, w = gl[k], wl[k]
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w), k


def test_generic_trees_both_directions(tmp_path):
    params, opt = make_tree(np.random.default_rng(0))
    p_path = ckpt.save(tmp_path / "port", 5, params, opt, data_cursor=17, extra={"run": "a"})
    r_path = ref_ckpt.save(tmp_path / "ref", 5, params, opt, data_cursor=17, extra={"run": "a"})
    assert p_path.name == r_path.name == "step_000000005"
    assert_same_files(p_path, r_path)
    meta = json.loads((p_path / "manifest.json").read_text())
    assert "params/layers/1/1/y" in meta["keys"] and "opt/mu/0" in meta["keys"]
    assert meta["keys"]["opt/codes"]["dtype"] == "uint16" and meta["data_cursor"] == 17

    # the reference restores the port's checkpoint, and the port the reference's
    rp, ro, rmeta = ref_ckpt.restore(tmp_path / "port", params_template=params,
                                     opt_template=opt)
    assert_same_tree(rp, params)
    assert_same_tree(ro, opt)
    pp, po, pmeta = ckpt.restore(tmp_path / "ref", params_template=params, opt_template=opt,
                                 device="cpu")
    assert_same_tree(pp, params)
    assert_same_tree(po, opt)
    assert isinstance(pp["layers"][1], tuple) and isinstance(pp["layers"][1][1], NT)
    assert pp["layers"][2] is None
    assert pmeta["data_cursor"] == rmeta["data_cursor"] == 17
    assert pmeta["extra"] == {"run": "a"}
    assert ckpt.restore(tmp_path / "ref", device="cpu")[:2] == (None, None)


@pytest.mark.parametrize("keep", [1, 3])
def test_keep_pruning_and_latest_step(tmp_path, keep):
    tree = {"w": np.arange(3.0)}
    for mod, root in ((ckpt, tmp_path / "port"), (ref_ckpt, tmp_path / "ref")):
        assert mod.latest_step(root) is None
        for step in (1, 2, 10, 4, 11):
            mod.save(root, step, tree, keep=keep)
    names = lambda root: sorted(p.name for p in root.iterdir())
    assert names(tmp_path / "port") == names(tmp_path / "ref")
    assert len(names(tmp_path / "port")) == keep
    assert ckpt.latest_step(tmp_path / "port") == ref_ckpt.latest_step(tmp_path / "ref") == 11
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "none", device="cpu")


def test_async_checkpointer_writes_what_save_writes(tmp_path):
    params, opt = make_tree(np.random.default_rng(1))
    tparams = {"emb": torch.arange(6, dtype=torch.float32).reshape(2, 3), "np": params}
    saver = ckpt.AsyncCheckpointer(tmp_path / "async", keep=2)
    for step in (1, 2, 3):
        saver.save(step, tparams, opt, data_cursor=step)
    saver.wait()
    assert saver.last_path.name == "step_000000003"
    assert sorted(p.name for p in (tmp_path / "async").iterdir()) == [
        "step_000000002", "step_000000003"]
    ckpt.save(tmp_path / "sync", 3, tparams, opt, data_cursor=3)
    ref_ckpt.save(tmp_path / "ref", 3, {"emb": np.arange(6, dtype=np.float32).reshape(2, 3),
                                        "np": params}, opt, data_cursor=3)
    assert_same_files(saver.last_path, tmp_path / "sync" / "step_000000003")
    assert_same_files(saver.last_path, tmp_path / "ref" / "step_000000003")


def test_bf16_tower_checkpoint_both_directions(tmp_path):
    """A reduced qwen1.5-4b tree cast to bfloat16.  The reference's save →
    the port's restore gives every leaf bit for bit as a ``torch.bfloat16``
    tensor.  The port's save (and ``AsyncCheckpointer``'s) writes the
    reference's files byte for byte: 2-byte words under the descr ``<V2``,
    the dtype ``"bfloat16"`` in the manifest, which ``np.load`` (the
    reference's reader) gives back bit for bit.  The reference's own
    ``restore`` cannot place such a leaf (``jnp.asarray`` of ``np.load``'s
    void array raises ``TypeError``, for its own checkpoints as for the
    port's: ROADMAP queue 3), so that direction is held at the files.  The
    tower's forward on the restored weights equals the forward on the
    originals."""
    import dataclasses

    import jax
    import ml_dtypes

    from repro.configs import registry as ref_registry
    from repro.models.api import get_model as ref_get_model
    from repro_torch.configs import registry
    from repro_torch.models import get_model, params_from_numpy
    from repro_torch.models.common import tree_leaves

    rcfg = dataclasses.replace(ref_registry.get_arch("qwen1.5-4b").reduced, dtype=jnp.bfloat16)
    rparams = jax.tree.map(np.asarray, ref_get_model(rcfg).init(jax.random.key(2)))
    cfg = dataclasses.replace(registry.get_arch("qwen1.5-4b").reduced, dtype=torch.bfloat16)
    params = params_from_numpy(cfg, rparams, device="cpu")
    ref_path = ref_ckpt.save(tmp_path / "ref", 3, rparams)

    back, _, meta = ckpt.restore(tmp_path / "ref", params_template=params, device="cpu")
    for (path, got), (_, want) in zip(tree_leaves(back), tree_leaves(rparams)):
        assert got.dtype == torch.bfloat16 and meta["keys"]["params/" + "/".join(path)][
            "dtype"] == "bfloat16"
        assert np.array_equal(got.view(torch.int16).numpy(), want.view(np.int16)), path

    port_path = ckpt.save(tmp_path / "port", 3, params)
    assert_same_files(port_path, ref_path)
    saver = ckpt.AsyncCheckpointer(tmp_path / "async")
    saver.save(3, params)
    saver.wait()
    assert_same_files(saver.last_path, ref_path)
    for key, info in meta["keys"].items():
        words = np.load(port_path / "arrays" / info["file"])
        assert words.dtype.itemsize == 2 and info["dtype"] == "bfloat16"
        want = rparams
        for k in key.split("/")[1:]:
            want = want[k]
        assert np.array_equal(words.view(ml_dtypes.bfloat16).view(np.int16),
                              want.view(np.int16)), key

    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (2, 9)))
    model = get_model(cfg)
    again, _, _ = ckpt.restore(tmp_path / "port", params_template=params, device="cpu")
    h0 = model.forward(params, toks)[0]
    for restored in (back, again):
        h1 = model.forward(restored, toks)[0]
        assert h1.dtype == torch.bfloat16 and torch.equal(h0.view(torch.int16),
                                                          h1.view(torch.int16))
