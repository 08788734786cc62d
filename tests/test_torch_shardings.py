"""The port's sharding plans (``models/common.py``'s ``spec`` mode,
``Model.specs``, ``launch/shardings.py``) against the reference's, as
tuples, and the blocks a process holds under them.

* ``param_specs`` of all ten archs, full and reduced, on the ``(16, 16)``
  and ``(2, 16, 16)`` production meshes and a ``(2, 2)`` mesh; the
  reference's ``spec`` mode reads only ``mesh.axis_names``,
  ``mesh.devices.shape`` and ``mesh.shape``, so a ``SimpleNamespace``
  stands in for its mesh (no devices needed).
* ``batch_spec``, ``decode_state_specs`` (all four families, MLA
  included; batches that split over the data axes and ones that do not,
  which move the spare axes onto the cache's sequence axis) and
  ``token_sharding``'s spec.
* ``resolve_axis``'s prefix cut and replication.
* ``shard_leaf`` / ``gather_leaf`` round trips: one process holding every
  shard; a hand-built mesh whose process holds shards 1 and 4 of a
  dimension split over ``("pod", "data")`` (a block that is not
  contiguous); and two gloo processes gathering such blocks back.
"""
import itertools
import math
import types

import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.launch import shardings as ref_shardings
from repro.models import common as ref_common
from repro_torch.configs import get_arch, list_archs
from repro_torch.launch import shardings
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.launch.sharded import spawn_ranks
from repro_torch.models import common, get_model

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x2": ((2, 2), ("data", "model")),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def ref_mesh(shape, axes):
    """What the reference's spec mode and plans read of a mesh."""
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape, np.int8),
                                 shape=dict(zip(axes, shape)))


def port_mesh(shape, axes):
    return make_mesh(shape, axes, device="cpu")


def spec_leaves(tree) -> list:
    """``(path, spec as a tuple)`` of a tree of nested dicts of specs."""
    if isinstance(tree, dict):
        return [(k,) + rest for k in sorted(tree) for rest in spec_leaves(tree[k])]
    return [(tuple(tree),)]


def state_specs(state) -> list:
    """The specs of a decode state (named tuples and tuples of specs)."""
    if isinstance(state, tuple) and type(state).__name__ != "PartitionSpec":
        return [x for v in state for x in state_specs(v)]
    return [tuple(state)]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_reference(arch, mesh_name):
    shape, axes = MESHES[mesh_name]
    rm, pm = ref_mesh(shape, axes), port_mesh(shape, axes)
    for which in ("config", "reduced"):
        rcfg = getattr(ref_registry.get_arch(arch), which)
        cfg = getattr(get_arch(arch), which)
        want = spec_leaves(ref_common.param_specs(rcfg, rm))
        got = spec_leaves(get_model(cfg).specs(pm))
        assert got == want, (arch, which)
        shard = get_model(cfg).shardings(pm)
        assert all(s.mesh is pm for _, s in common.tree_leaves(shard))
        assert [tuple(s.spec) for _, s in common.tree_leaves(shard)] == [w[-1] for w in want]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_decode_and_token_specs_match_reference(monkeypatch, mesh_name):
    shape, axes = MESHES[mesh_name]
    rm, pm = ref_mesh(shape, axes), port_mesh(shape, axes)
    assert tuple(shardings.batch_shardings(pm).spec) == tuple(ref_common.batch_spec(rm))
    # the reference wraps specs in NamedSharding, which needs a real mesh
    monkeypatch.setattr(ref_shardings, "NamedSharding", lambda mesh, spec: spec)
    dp = math.prod(s for a, s in zip(axes, shape) if a != "model")
    for B, S in ((dp * 2, 4096), (1, 524_288), (3, 1000)):
        assert tuple(shardings.token_sharding(pm, B).spec) == \
            tuple(ref_shardings.token_sharding(rm, B))
        for arch in list_archs():
            for which in ("config", "reduced"):
                rcfg = getattr(ref_registry.get_arch(arch), which)
                cfg = getattr(get_arch(arch), which)
                want = state_specs(ref_shardings.decode_state_specs(rcfg, rm, B, S))
                got_tree = shardings.decode_state_specs(cfg, pm, B, S)
                assert state_specs(got_tree) == want, (arch, which, B, S)
                placed = shardings.decode_state_shardings(cfg, pm, B, S)
                assert type(placed) is type(got_tree)


def test_specs_cover_mla_and_every_family():
    """The decode-state plans reach all four families and the MLA cache."""
    families = {get_arch(a).config.family for a in list_archs()}
    assert families == {"decoder", "encdec", "rwkv6", "zamba2"}
    assert any(get_arch(a).config.mla for a in list_archs())


@pytest.mark.parametrize("dim", [1, 2, 6, 16, 30, 48, 64, 96, 100])
@pytest.mark.parametrize("logical", ["embed", "mlp", "vocab", "layers", None, "unknown"])
def test_resolve_axis_prefix_cut(dim, logical):
    """A dimension that does not divide over its axes keeps a dividing
    prefix (48 over pod × data = 32 keeps ``pod``), else is replicated."""
    ms = {"pod": 2, "data": 16, "model": 16}
    rules = dict(common.DEFAULT_RULES)
    want = ref_common.resolve_axis(logical, dim, ms, ref_common.DEFAULT_RULES)
    assert common.resolve_axis(logical, dim, ms, rules) == want
    assert common.resolve_axis("embed", 48, ms, rules) == ("pod",)
    assert common.resolve_axis("embed", 64, ms, rules) == ("pod", "data")
    assert common.resolve_axis("mlp", 100, ms, rules) is None


def test_resolve_spec_uses_an_axis_once_and_rules_update():
    ms = {"data": 4, "model": 2}
    for shape, axes in (((8, 8), ("mlp", "heads")), ((8, 6, 4), ("embed", "embed", "mlp")),
                        ((3, 8), ("vocab", "embed"))):
        want = tuple(ref_common.resolve_spec(shape, axes, ms, ref_common.DEFAULT_RULES))
        assert tuple(common.resolve_spec(shape, axes, ms, common.DEFAULT_RULES)) == want
    rules = {**common.DEFAULT_RULES, "embed": ("model", "data")}
    assert tuple(common.resolve_spec((8,), ("embed",), ms, rules)) == (("model", "data"),)
    assert common.P(("data",), None) == ("data", None)       # one-name tuples are the name


def full_of(shape) -> torch.Tensor:
    return torch.arange(math.prod(shape), dtype=torch.float32).reshape(shape)


def test_one_process_blocks_are_whole():
    mesh = port_mesh((2, 2), ("data", "model"))
    x = full_of((8, 6, 4))
    for spec in (common.P("data", "model"), common.P(("data", "model")), common.P(),
                 common.P(None, "data")):
        blk = shardings.shard_leaf(x, mesh, spec)
        assert torch.equal(blk, x) and blk.data_ptr() != x.data_ptr()
        assert torch.equal(shardings.gather_leaf(blk, mesh, spec), x)
    with pytest.raises(ValueError, match="does not split"):
        shardings.shard_leaf(full_of((6, 3)), mesh, common.P(None, "model"))


def hand_mesh(shape, axes, procs, coords) -> Mesh:
    """A mesh as process ``coords`` of a ``procs`` grid sees it (no group)."""
    return Mesh(tuple(shape), tuple(axes), torch.device("cpu"), tuple(procs), tuple(coords), {})


def expected_block(x, shape, axes, procs, coords, spec):
    """A process's block by brute force: along each dimension, the shards
    it holds in ascending flat order."""
    mesh = hand_mesh(shape, axes, procs, coords)
    out = x
    for d, entry in enumerate(spec):
        dim_axes = () if entry is None else ((entry,) if isinstance(entry, str) else entry)
        if not dim_axes:
            continue
        n = math.prod(mesh.size(a) for a in dim_axes)
        held = mesh.local_shards(dim_axes)
        chunk = x.shape[d] // n
        idx = torch.cat([torch.arange(h * chunk, (h + 1) * chunk) for h in held])
        out = out.index_select(d, idx)
    return out


def test_non_contiguous_block():
    """Six processes over a (4, 3) (pod, data) mesh take (2, 3) of it: the
    process at (0, 1) holds pods 0-1 and data shard 1, so along a dimension
    split over (pod, data) (shard pod * 3 + data) it holds shards 1 and 4."""
    shape, axes, procs = (4, 3), ("pod", "data"), (2, 3)
    x = full_of((24, 5))
    spec = common.P(("pod", "data"), None)
    mesh = hand_mesh(shape, axes, procs, (0, 1))
    assert mesh.local_shards(("pod", "data")) == [1, 4]
    blk = shardings.shard_leaf(x, mesh, spec)
    assert torch.equal(blk, torch.cat([x[2:4], x[8:10]]))
    # every process's block by brute force, and the blocks tile the leaf once
    seen = torch.zeros(24, dtype=torch.int64)
    for coords in itertools.product(*(range(p) for p in procs)):
        m = hand_mesh(shape, axes, procs, coords)
        b = shardings.shard_leaf(x, m, spec)
        assert b.shape == shardings.block_shape(x.shape, m, spec)
        assert torch.equal(b, expected_block(x, shape, axes, procs, coords, spec))
        seen[b[:, 0].long() // 5] += 1
    # each row is held by the processes along the axes the spec leaves out:
    # none here, so every row is held exactly once
    assert bool((seen == 1).all())
    # the reversed order: a dimension over (data, pod)
    spec2 = common.P(None, ("data", "pod"))
    y = full_of((2, 24))
    b2 = shardings.shard_leaf(y, mesh, spec2)
    assert torch.equal(b2, expected_block(y, shape, axes, procs, (0, 1), spec2))


def _round_trip_rank(rank, world, out_dir):
    """Blocks of the same leaves on every rank, gathered back."""
    torch.set_num_threads(1)
    mesh = make_mesh((2, 2), ("pod", "data"), device="cpu")
    x = full_of((8, 12))
    results = {}
    for name, spec in (("dp", common.P(("data", "pod"), None)),       # not contiguous
                       ("both", common.P("pod", "data")), ("one", common.P(None, "pod")),
                       ("none", common.P())):
        blk = shardings.shard_leaf(x, mesh, spec)
        results[name] = shardings.gather_leaf(blk, mesh, spec).numpy()
        results[name + "_block"] = blk.numpy()
    np.savez(f"{out_dir}/rank{rank}.npz", **results)


def test_gather_leaf_across_two_processes(tmp_path):
    """Two gloo processes on a (2, 2) (pod, data) mesh hold pods 0 and 1; a
    dimension split over (data, pod) gives each of them shards {0, 2} or
    {1, 3}; every leaf gathers back whole on both."""
    spawn_ranks(_round_trip_rank, 2, (str(tmp_path),), init_file=tmp_path / "init",
                timeout=120)
    x = full_of((8, 12)).numpy()
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        for name in ("dp", "both", "one", "none"):
            assert np.array_equal(got[name], x), (r, name)
        # rank r holds pod r: along (data, pod) that is shards r and r + 2
        assert np.array_equal(got["dp_block"], np.concatenate([x[2 * r:2 * r + 2],
                                                               x[2 * r + 4:2 * r + 6]]))
