"""The bench tables the port added for the reference's index half, on the
CPU at a small size: each returns the reference's row names, with the
backends renamed (``xla`` → ``torch``, ``pallas`` → ``cuda``, ``legacy``
kept; the CPU runs ``legacy`` and ``torch``), and its own asserts hold."""
import pytest
import torch

from repro_torch.bench import common, tables

SEMS = ("if", "is", "rs", "rf")
SMALL_CFG = common.UGConfig(ef_spatial=12, ef_attribute=24, max_edges_if=12, max_edges_is=12,
                            iterations=2, repair_width=8, exact_spatial=True, block=128)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The shapes here are tiny: torch's intra-op pool only contends with the
    other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def small():
    return common.Bench(n=300, dim=8, nq=8, device="cpu", cfg=SMALL_CFG)


@pytest.fixture
def one_call(monkeypatch):
    monkeypatch.setattr(common, "TIMED_CALLS", (0, 1))    # the rows matter here, not the times


def names(rows):
    return [r["name"] for r in rows]


def test_beam_sweep_rows(small, one_call):
    rows = tables.bench_beam_sweep(small)
    assert names(rows) == [f"beam_{s}_{b}_ef{ef}" for s in SEMS for ef in (32, 96)
                           for b in ("legacy", "torch")]
    for legacy, fused in zip(rows[::2], rows[1::2]):
        assert fused["metrics"]["merge_cmp_per_expansion"] < \
            legacy["metrics"]["merge_cmp_per_expansion"]


def test_mixed_workload_rows(small, one_call):
    rows = tables.bench_mixed_workload(small, require_speedup=2.0)
    assert names(rows) == ["mixed_step_profile_legacy", "mixed_step_profile_torch",
                           "mixed_interleaved_4sem", "mixed_split_4x_per_sem"]
    assert "cpu_qps=" in rows[2]["derived"] and "recall_rs=" in rows[2]["derived"]
    assert rows[0]["metrics"]["cc_pairwise"] and not rows[1]["metrics"]["cc_pairwise"]


def test_memory_rows(small, one_call):
    rows = tables.bench_memory(small, require_reduction=3.0)
    assert names(rows) == [f"memory_{t}" for t in ("f32", "bf16", "int8", "int8_rerank", "pq",
                                                   "pq_rerank")] + ["memory_summary"]
    assert rows[2]["metrics"]["plane_bytes"] == rows[3]["metrics"]["plane_bytes"]
    assert rows[3]["metrics"]["rerank_bytes"] == 4 * 8


def test_build_rows(one_call):
    rows = tables.bench_build((200,), dim=8, device="cpu")
    assert names(rows) == (
        [f"build_sweep_profile_{b}" for b in ("legacy", "torch")]
        + [f"build_{b}_n200" for b in ("legacy", "torch")] + ["build_sharded_n200"])
    assert rows[0]["metrics"]["quadratic"] and not rows[1]["metrics"]["quadratic"]
    assert rows[2]["metrics"]["graph_checksum"] == rows[3]["metrics"]["graph_checksum"]
    assert rows[-1]["metrics"]["rows"] == 200


def test_scalability_and_sensitivity_rows(small, one_call):
    scale = tables.bench_scalability(small, sizes=(200, 300))
    assert names(scale) == ["scale_n200", "scale_n300"]
    sens = tables.bench_sensitivity(common.Bench(n=150, dim=8, nq=8, device="cpu"))
    assert names(sens) == [f"sens_{t}" for t in (
        "ef_attr_16", "ef_attr_48", "ef_attr_96", "ef_spatial_8", "ef_spatial_24",
        "ef_spatial_48", "iters_1", "iters_2", "iters_4", "max_edges_8", "max_edges_24",
        "max_edges_48")]
    assert all(0.0 <= r["metrics"]["recall"] <= 1.0 for r in scale + sens)
