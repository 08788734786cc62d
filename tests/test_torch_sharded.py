"""The port's row-sharded index against the reference's, bit for bit, on
the CPU, at S = 4 shards held by this one process.

The reference runs once, split over four subprocesses with 4 fake CPU
devices each (the device count must be fixed before JAX starts), while the
port computes the same things here.  Inputs: integer-valued vectors
(|v| ≤ 4, d = 8), n = 402 rows (so round-robin shards 2 and 3 carry a pad
row), intervals on a 1/16 grid, 16 queries cycling IF/IS/RS/RF.  Held equal bit for bit:

* ``build_sharded_index_host``'s arrays (exact-KNN builds);
* ``build_sharded_store``'s ``nbrs``/``status``/``global_ids``, f32 and
  int8 + rerank (with the int8 plane and its parameters);
* ``make_ring_knn_fn`` ids and distances, global and own-shard;
* sharded search ids and distances: static IF and mixed on ``(data,)``,
  mixed with hierarchical and flat merge on a ``(2, 2)`` ``(pod, data)`` mesh;
* every ``make_shard_probe_fns`` callable's output.

Besides: the merged probes equal the sharded answer, the device build's
recall is within 0.01 of the host build's on Gaussian data (the reference's
own bar), and the entry points need a card unless the CPU is asked for.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import Semantics, UGConfig, brute_force, recall
from repro_torch.core import intervals as iv
from repro_torch.core.candidates import _smallest
from repro_torch.core.search import SearchResult
from repro_torch.core.sharded import (
    _ring_knn_step_fn, _smallest_stable, build_sharded_index_host, build_sharded_store,
    local_shard_view, make_ring_knn_fn, make_shard_probe_fns, make_sharded_search_fn,
    shard_index,
)
from repro_torch.launch.mesh import make_host_mesh, make_mesh

REPO = pathlib.Path(__file__).resolve().parent.parent
N, D, S, NQ, RING_K = 402, 8, 4, 16, 8
CFG = dict(ef_spatial=8, ef_attribute=16, max_edges_if=8, max_edges_is=8, iterations=2,
           repair_width=4, exact_spatial=True, block=64)
SEARCH = dict(ef=16, k=5, width=4)
HOST_KEYS = ("hx", "hi", "hn", "hs", "hg")

# The reference's part of the work, in four subprocesses that run side by
# side (its programs compile for about a minute in all): the host build and
# the int8 store; the device build's ring and one-axis searches; the
# two-axis searches; the probes.
REF_PARTS = ("host", "one_axis", "two_axis", "probes")
REF_SCRIPT = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.core import intervals as iv
from repro.core.build import UGConfig
from repro.core import sharded as sh
from repro.launch.mesh import make_mesh

part, inp, out, cfg, search, S, RK = sys.argv[1], sys.argv[2], sys.argv[3], *map(
    json.loads, sys.argv[4:])
d = np.load(inp)
x, ints = d["x"], d["intervals"]
qv, qi, flags = (jnp.asarray(d[k]) for k in ("qv", "qi", "flags"))
cfg = UGConfig(**cfg)
mesh = make_mesh((S,), ("data",))
res = {}
if part == "host":
    res.update(zip(("hx", "hi", "hn", "hs", "hg"), sh.build_sharded_index_host(x, ints, S, cfg)))
    q8 = sh.build_sharded_store(mesh, x, ints, cfg, dtype="int8", rerank=True)
    res.update(q8_nbrs=q8.store.nbrs, q8_status=q8.store.status, q8_gids=q8.global_ids,
               q8_plane=q8.store.plane.data, q8_scale=q8.store.plane.scale,
               q8_zero=q8.store.plane.zero, q8_rerank=q8.store.rerank.data)
else:
    dev = sh.build_sharded_store(mesh, x, ints, cfg)
if part == "one_axis":
    res.update(dev_nbrs=dev.store.nbrs, dev_status=dev.store.status, dev_gids=dev.global_ids,
               dev_x=dev.store.plane.data, dev_iv=dev.store.intervals)
    row = P(("data",))
    res["ring_ids"], res["ring_dist"] = sh.make_ring_knn_fn(mesh, axis="data", k=RK)(
        dev.store.plane.data, dev.global_ids)
    own = jax.jit(shard_map(sh._ring_knn_step_fn("data", RK, same_shard_of=S), mesh=mesh,
                            in_specs=(row, row), out_specs=(row, row), check_vma=False))
    res["own_ids"], res["own_dist"] = own(dev.store.plane.data, dev.global_ids)
    fn = sh.make_sharded_search_fn(mesh, index_axes=("data",), sem=iv.Semantics.IF, **search)
    res["if_ids"], res["if_dist"] = fn(dev, qv, qi)
    fn = sh.make_sharded_search_fn(mesh, index_axes=("data",), mixed=True, **search)
    res["mixed_ids"], res["mixed_dist"] = fn(dev, qv, qi, flags)
if part == "probes":
    for s, probe in enumerate(sh.make_shard_probe_fns(dev, S, **search)):
        res[f"probe{s}_ids"], res[f"probe{s}_dist"] = probe(qv, qi, flags)
if part == "two_axis":
    mesh22 = make_mesh((2, 2), ("pod", "data"))
    s22 = sh.shard_index(mesh22, ("pod", "data"), *(np.asarray(a) for a in (
        dev.store.plane.data, dev.store.intervals, dev.store.nbrs, dev.store.status,
        dev.global_ids)))
    for hier in (True, False):
        fn = sh.make_sharded_search_fn(mesh22, index_axes=("pod", "data"),
                                       hierarchical=hier, mixed=True, **search)
        res[f"hier{int(hier)}_ids"], res[f"hier{int(hier)}_dist"] = fn(s22, qv, qi, flags)
np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
"""


def as_bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_bitwise(port, ref, what):
    port, ref = as_bits(port), as_bits(ref)
    assert port.shape == ref.shape and port.dtype == ref.dtype, (what, port.shape, ref.shape)
    assert np.array_equal(port, ref), what


def grid_intervals(rng, n):
    """Intervals on a 1/16 grid of [0, 1] (exact in f32, no subnormals)."""
    return np.sort(rng.integers(0, 17, (n, 2)), axis=-1).astype(np.float32) / 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small shapes: torch's intra-op pool would only contend with the
    reference's subprocesses and the other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The inputs, and the reference's subprocesses started on them."""
    rng = np.random.default_rng(20)
    x = rng.integers(-4, 5, (N, D)).astype(np.float32)
    ints = grid_intervals(rng, N)
    qv = rng.integers(-4, 5, (NQ, D)).astype(np.float32)
    qi = grid_intervals(rng, NQ)
    point = np.arange(NQ) % 4 >= 2                     # RS and RF rows: point windows
    qi[point, 1] = qi[point, 0]
    flags = np.asarray([iv.FLAG_IF, iv.FLAG_IS, iv.FLAG_IS, iv.FLAG_IF] * (NQ // 4), np.int32)
    path = tmp_path_factory.mktemp("sharded")
    inputs = path / "inputs.npz"
    np.savez(inputs, x=x, intervals=ints, qv=qv, qi=qi, flags=flags)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    procs = {part: subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, part, str(inputs), str(path / f"{part}.npz"),
         json.dumps(CFG), json.dumps(SEARCH), json.dumps(S), json.dumps(RING_K)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for part in REF_PARTS}
    yield dict(x=x, ints=ints, qv=torch.as_tensor(qv), qi=torch.as_tensor(qi),
               flags=torch.as_tensor(flags), procs=procs, path=path)
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def port(case):
    """The port's side, computed while the reference runs."""
    cfg = UGConfig(**CFG)
    mesh = make_mesh((S,), ("data",), device="cpu")
    mesh22 = make_mesh((2, 2), ("pod", "data"), device="cpu")
    res = dict(zip(HOST_KEYS, build_sharded_index_host(case["x"], case["ints"], S, cfg,
                                                       device="cpu")))
    dev = build_sharded_store(mesh, case["x"], case["ints"], cfg)
    q8 = build_sharded_store(mesh, case["x"], case["ints"], cfg, dtype="int8", rerank=True)
    res.update(dev_nbrs=dev.store.nbrs, dev_status=dev.store.status, dev_gids=dev.global_ids,
               dev_x=dev.store.plane.data, dev_iv=dev.store.intervals,
               q8_nbrs=q8.store.nbrs, q8_status=q8.store.status, q8_gids=q8.global_ids,
               q8_plane=q8.store.plane.data, q8_scale=q8.store.plane.scale,
               q8_zero=q8.store.plane.zero, q8_rerank=q8.store.rerank.data)
    xs, gids = dev.store.plane.data, dev.global_ids
    res["ring_ids"], res["ring_dist"] = make_ring_knn_fn(mesh, k=RING_K)(xs, gids)
    res["own_ids"], res["own_dist"] = _ring_knn_step_fn(mesh, "data", RING_K,
                                                        same_shard_of=S)(xs, gids)
    qv, qi, flags = case["qv"], case["qi"], case["flags"]
    fn = make_sharded_search_fn(mesh, sem=Semantics.IF, **SEARCH)
    res["if_ids"], res["if_dist"] = fn(dev, qv, qi)
    fn = make_sharded_search_fn(mesh, mixed=True, **SEARCH)
    res["mixed_ids"], res["mixed_dist"] = fn(dev, qv, qi, flags)
    st = dev.store
    s22 = shard_index(mesh22, ("pod", "data"), st.plane.data, st.intervals, st.nbrs, st.status,
                      dev.global_ids)
    for hier in (True, False):
        fn = make_sharded_search_fn(mesh22, index_axes=("pod", "data"), hierarchical=hier,
                                    mixed=True, **SEARCH)
        res[f"hier{int(hier)}_ids"], res[f"hier{int(hier)}_dist"] = fn(s22, qv, qi, flags)
    for s, probe in enumerate(make_shard_probe_fns(dev, S, **SEARCH)):
        res[f"probe{s}_ids"], res[f"probe{s}_dist"] = probe(qv, qi, flags)
    return res


@pytest.fixture(scope="module")
def ref(case, port):
    """The reference's results (waits for its subprocesses)."""
    res = {}
    for part, proc in case["procs"].items():
        try:
            _, err = proc.communicate(timeout=150)
        except subprocess.TimeoutExpired:
            proc.kill()
            pytest.fail(f"the reference's {part} run did not end within 150 s")
        assert proc.returncode == 0, err[-3000:]
        res.update(np.load(case["path"] / f"{part}.npz"))
    return res


@pytest.mark.parametrize("key", HOST_KEYS)
def test_host_build_bitwise(port, ref, key):
    assert_bitwise(port[key], ref[key], key)


@pytest.mark.parametrize("key", ["dev_nbrs", "dev_status", "dev_gids", "dev_x", "dev_iv"])
def test_device_build_bitwise(port, ref, key):
    assert_bitwise(port[key], ref[key], key)


@pytest.mark.parametrize("key", ["q8_nbrs", "q8_status", "q8_gids", "q8_plane", "q8_scale",
                                 "q8_zero", "q8_rerank"])
def test_device_build_int8_rerank_bitwise(port, ref, key):
    assert_bitwise(port[key], ref[key], key)


@pytest.mark.parametrize("ring", ["ring", "own"])
def test_ring_knn_bitwise(port, ref, ring):
    assert_bitwise(port[f"{ring}_ids"], ref[f"{ring}_ids"], f"{ring} ids")
    assert_bitwise(port[f"{ring}_dist"], ref[f"{ring}_dist"], f"{ring} dist")


@pytest.mark.parametrize("search", ["if", "mixed", "hier1", "hier0"])
def test_sharded_search_bitwise(port, ref, search):
    assert_bitwise(port[f"{search}_ids"], ref[f"{search}_ids"], f"{search} ids")
    assert_bitwise(port[f"{search}_dist"], ref[f"{search}_dist"], f"{search} dist")


@pytest.mark.parametrize("shard", range(S))
def test_probe_fns_bitwise(port, ref, shard):
    assert_bitwise(port[f"probe{shard}_ids"], ref[f"probe{shard}_ids"], "probe ids")
    assert_bitwise(port[f"probe{shard}_dist"], ref[f"probe{shard}_dist"], "probe dist")


def test_sharded_answer_is_the_merged_probes(port):
    """The sharded step's merge is a stable sort of the shard-major
    concatenation of what the probes return."""
    ids = torch.cat([port[f"probe{s}_ids"] for s in range(S)], dim=1)
    dist = torch.cat([port[f"probe{s}_dist"] for s in range(S)], dim=1)
    dist, order = torch.sort(dist, dim=1, stable=True)
    k = SEARCH["k"]
    assert torch.equal(torch.gather(ids, 1, order[:, :k]), port["mixed_ids"])
    assert torch.equal(dist[:, :k], port["mixed_dist"])


def test_one_axis_meshes_agree(case, port):
    """A replicated ``model`` axis adds no shards: a ``(4, 2)`` ``(data,
    model)`` mesh answers as ``(4,)`` does."""
    mesh = make_mesh((S, 2), ("data", "model"), device="cpu")
    sidx = shard_index(mesh, ("data",), *(port[k] for k in ("dev_x", "dev_iv", "dev_nbrs",
                                                             "dev_status", "dev_gids")))
    fn = make_sharded_search_fn(mesh, mixed=True, **SEARCH)
    ids, dist = fn(sidx, case["qv"], case["qi"], case["flags"])
    assert torch.equal(ids, port["mixed_ids"]) and torch.equal(dist, port["mixed_dist"])
    assert make_host_mesh(device="cpu").shape == (1, 1)


@pytest.mark.parametrize("k", [1, 3, 8, 39, 40])
def test_smallest_stable_matches_a_stable_sort(k):
    rng = np.random.default_rng(k)
    d = torch.as_tensor(rng.integers(0, 5, (64, 40)).astype(np.float32))
    d[d == 4] = torch.inf                               # masked entries tie at +inf
    got, want = _smallest_stable(d, k), _smallest(d, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_device_build_recall_matches_host_build():
    """Gaussian data (the reference's test_sharded_build): the device
    build's sharded recall within 0.01 of the host build's, IF and IS."""
    rng = np.random.default_rng(5)
    n, d, nq = 1200, 12, 24
    x = rng.normal(size=(n, d)).astype(np.float32)
    ints = np.sort(rng.uniform(size=(n, 2)), axis=-1).astype(np.float32)
    cfg = UGConfig(ef_spatial=16, ef_attribute=32, max_edges_if=16, max_edges_is=16,
                   iterations=2, repair_width=8, exact_spatial=True, block=512)
    mesh = make_mesh((S,), ("data",), device="cpu")
    host = shard_index(mesh, ("data",), *build_sharded_index_host(x, ints, S, cfg, device="cpu"))
    dev = build_sharded_store(mesh, x, ints, cfg)
    qv = torch.as_tensor(rng.normal(size=(nq, d)).astype(np.float32))
    c = rng.uniform(size=(nq, 1))
    qi = torch.as_tensor(np.concatenate([np.maximum(c - 0.3, 0), np.minimum(c + 0.3, 1)],
                                        axis=1).astype(np.float32))
    for sem in (Semantics.IF, Semantics.IS):
        fn = make_sharded_search_fn(mesh, sem=sem, ef=64, k=10)
        gt = brute_force(torch.as_tensor(x), torch.as_tensor(ints), qv, qi, sem=sem, k=10)
        r_host = recall(SearchResult(*fn(host, qv, qi), None), gt)
        r_dev = recall(SearchResult(*fn(dev, qv, qi), None), gt)
        assert r_dev >= r_host - 0.01, (sem, r_dev, r_host)


def test_views_need_whole_shards(port):
    mesh = make_mesh((S,), ("data",), device="cpu")
    sidx = shard_index(mesh, ("data",), *(port[k] for k in ("dev_x", "dev_iv", "dev_nbrs",
                                                             "dev_status", "dev_gids")))
    with pytest.raises(ValueError):
        local_shard_view(sidx, 0, 3)
    with pytest.raises(ValueError):
        make_sharded_search_fn(mesh, index_axes=("pod",))
    with pytest.raises(NotImplementedError):
        build_sharded_store(make_mesh((2, 2), ("pod", "data"), device="cpu"), port["dev_x"],
                            port["dev_iv"], UGConfig(**CFG), index_axes=("pod", "data"))
    fn = make_sharded_search_fn(mesh, plane_tag="int8", has_rerank=True)
    with pytest.raises(ValueError):
        fn(sidx, torch.zeros(1, D), torch.zeros(1, 2))


def test_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    x = np.zeros((8, 2), np.float32)
    ints = np.tile(np.asarray([[0.0, 1.0]], np.float32), (8, 1))
    with pytest.raises(RuntimeError):
        make_mesh((2,), ("data",))
    with pytest.raises(RuntimeError):
        make_host_mesh()
    with pytest.raises(RuntimeError):
        build_sharded_index_host(x, ints, 2, UGConfig(**CFG))
