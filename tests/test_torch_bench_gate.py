"""The port's bench gate and its remaining tables, on the CPU.

* ``parse_metrics``, ``gated_metrics``, ``write_baseline`` and
  ``check_baseline`` of ``repro_torch.bench.run`` agree with the
  reference's ``benchmarks/run.py`` on the same rows: a clean run, a
  missing row, a vanished metric, a recall below its floor and a byte
  count above its ceiling.
* ``--smoke --device cpu --check`` against the committed
  ``baseline_smoke.json`` exits 0 on a subset of benches (the build
  table), and a breach of the baseline or a missing row fails.

The tables' rows are held in ``tests/test_torch_bench_tables.py``.
"""
import contextlib
import io
import json
import pathlib
import sys

import pytest
import torch

from repro_torch.bench import run

ROOT = pathlib.Path(__file__).resolve().parents[1]
BASELINE = ROOT / "src" / "repro_torch" / "bench" / "baseline_smoke.json"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The shapes here are tiny: torch's intra-op pool only contends with the
    other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref_run():
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks import run as ref
    finally:
        sys.path.remove(str(ROOT))
    return ref


ROWS = [
    {"name": "beam_if_legacy_ef32", "us_per_call": 1.0,
     "derived": "recall=0.981 qps=464 hops=31.7 merge_cmp_per_expansion=1792"},
    {"name": "memory_int8_rerank", "us_per_call": 2.0,
     "derived": "recall=1.000 plane_bytes=24 rerank_bytes=96 qps=85"},
    {"name": "updates_churn_is", "us_per_call": 3.0,
     "derived": "recall=0.912 recall_fresh_rebuild=0.950 gap=+0.038 qps=1200"},
    {"name": "build_legacy_n400", "us_per_call": 4.0,
     "derived": "seconds=1.1 edges=8646 graph_checksum=1765997 peak_sweep_bytes=75497472"},
    {"name": "mixed_split_4x_per_sem", "us_per_call": 5.0,
     "derived": "cpu_qps=45 sync_iters=133 sync_speedup_interleaved=3.91x"},
    {"name": "scale_n1e6", "us_per_call": 6.0, "derived": "recall=2.5e-1 qps=1e5 bytes=-3"},
]


@pytest.mark.parametrize("row", ROWS, ids=lambda r: r["name"])
def test_parse_and_gated_metrics_agree_with_reference(ref_run, row):
    assert run.parse_metrics(row["derived"]) == ref_run.parse_metrics(row["derived"])
    assert run.gated_metrics(row["derived"]) == ref_run.gated_metrics(row["derived"])


def broken(rows, case):
    """``rows`` with one regression of kind ``case``."""
    rows = [dict(r) for r in rows]
    if case == "missing_row":
        rows = rows[1:]
    elif case == "vanished_metric":
        rows[1]["derived"] = "recall=1.000 plane_bytes=24 qps=85"
    elif case == "floor_breach":
        rows[2]["derived"] = "recall=0.850 recall_fresh_rebuild=0.950 gap=+0.100 qps=1200"
    elif case == "ceiling_breach":
        rows[3]["derived"] = rows[3]["derived"].replace("75497472", "99999999")
    return rows


@pytest.mark.parametrize("case", ["clean", "missing_row", "vanished_metric", "floor_breach",
                                  "ceiling_breach"])
def test_baseline_write_and_check_agree_with_reference(ref_run, tmp_path, case):
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    run.write_baseline(ROWS, str(ours))
    ref_run.write_baseline(ROWS, str(theirs))
    assert ours.read_text() == theirs.read_text()
    rows = broken(ROWS, case)
    got = run.check_baseline(rows, str(ours))
    assert got == ref_run.check_baseline(rows, str(theirs))
    assert bool(got) == (case != "clean")


def test_check_without_a_baseline_fails(tmp_path):
    problems = run.check_baseline(ROWS, str(tmp_path / "absent.json"))
    assert len(problems) == 1 and "not found" in problems[0]


def test_only_scopes_the_gate_to_the_selected_benches(tmp_path):
    """A baseline that lists its benches holds a subset run to the rows of
    the selected benches; a missing row of a selected bench still fails."""
    path = tmp_path / "base.json"
    benches = {"beam_sweep": ["beam_if_legacy_ef32"], "memory": ["memory_int8_rerank"],
               "updates": ["updates_churn_is"], "build": ["build_legacy_n400"]}
    run.write_baseline(ROWS, str(path), benches=benches)
    saved = json.loads(path.read_text())
    assert saved["benches"] == benches
    assert run.check_baseline(ROWS[:1], str(path), only=["beam"]) == []
    assert run.check_baseline(ROWS[1:2], str(path), only=["beam"]) == [
        "beam_if_legacy_ef32: row missing from this run (bench removed or crashed)"]
    assert len(run.check_baseline(ROWS[:1], str(path))) == 4    # every other gated row


def test_committed_baseline_covers_the_gated_tables():
    """The baseline holds the rows of every table with a recall or byte
    metric that a CPU smoke run completes.  The serve table's async/sync
    QPS ratio does not hold its 0.85 bar reliably on the CPU (PERF.md §6,
    PR 21), so its rows are held by the card's run of its own asserts."""
    saved = json.loads(BASELINE.read_text())
    assert saved["schema"] == 1
    assert {"ifann", "query_types", "workloads", "indexing", "vary_k", "sensitivity",
            "scalability", "beam_sweep", "mixed_workload", "build", "updates",
            "memory"} == set(saved["benches"])
    assert "updates_profile_legacy" in saved["rows"]
    assert all(saved["rows"][n] for names in saved["benches"].values() for n in names)


@pytest.fixture(scope="module")
def smoke_build(tmp_path_factory):
    """A CPU smoke run of the build bench checked against the committed
    baseline: its exit code, its rows and what it printed."""
    out = tmp_path_factory.mktemp("smoke") / "rows.json"
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = run.main(["--smoke", "--device", "cpu", "--only", "build", "--check", str(BASELINE),
                       "--json", str(out)])
    return rc, json.loads(out.read_text())["rows"], err.getvalue()


def test_smoke_check_against_committed_baseline(smoke_build):
    """The gate of a CPU smoke run over the build bench is clean against
    the committed baseline."""
    rc, rows, err = smoke_build
    assert rc == 0 and "perf gate: clean" in err
    assert {r["name"] for r in rows} >= {"build_legacy_n400", "build_torch_n400",
                                         "build_sweep_profile_legacy", "build_sharded_n400"}


def test_smoke_check_fails_on_a_breach(smoke_build, tmp_path):
    """The same rows against a baseline whose byte ceiling is one byte below
    this run's fail; so does a run that lacks a committed row."""
    _, rows, _ = smoke_build
    saved = json.loads(BASELINE.read_text())
    row = saved["rows"]["build_sweep_profile_torch"]
    row["max"]["peak_intermediate_bytes"] = int(
        row["max"]["peak_intermediate_bytes"] / run.BYTES_HEADROOM) - 1
    tight = tmp_path / "tight.json"
    tight.write_text(json.dumps(saved))
    problems = run.check_baseline(rows, str(tight), only=["build"])
    assert len(problems) == 1 and problems[0].startswith(
        "build_sweep_profile_torch: peak_intermediate_bytes=")
    absent = tmp_path / "absent_row.json"
    absent.write_text(json.dumps({"schema": 1, "rows": {"kernel_gone": {"min": {"recall": 0.5}}},
                                  "benches": {"kernels": ["kernel_gone"]}}))
    assert run.main(["--device", "cpu", "--only", "kernels", "--check", str(absent)]) == 1
