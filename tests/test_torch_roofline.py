"""The port's roofline (``launch/roofline.py``) against the reference's, and
the dry-run's CLI (``launch/dryrun.py``) on a full-width cell
(``tests/test_torch_dryrun_cells.py`` runs every reduced cell).

* ``model_flops`` equals the reference's for every arch × shape, exactly.
* ``analyze`` equals the reference's on the same records, for the single
  and the multi mesh, with the reference's constants patched into the
  port's module (the port's own are the H100's).
* The CLI counts a full-width cell and the roofline reads its record.
"""
import json

import pytest
import torch

from repro.launch import roofline as ref_roofline
from repro_torch.configs.registry import ARCHS, SHAPES
from repro_torch.launch import dryrun, roofline

CELLS = [(a, s) for a in sorted(ARCHS) for s in SHAPES]
@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_the_reference(arch, shape):
    assert roofline.model_flops(arch, shape) == ref_roofline.model_flops(arch, shape)
    assert roofline.model_flops(arch, {"shape": shape}) == \
        ref_roofline.model_flops(arch, {"shape": shape})


def records(mesh: str) -> list[dict]:
    """A record of every cell with made-up counts, a skipped and a failed
    one, and the index cell's (no model FLOPs)."""
    out = []
    for i, (arch, shape) in enumerate(CELLS):
        out.append(dict(arch=arch, shape=shape, mesh=mesh, ok=True,
                        flops=1.5e13 * (i + 1), bytes_accessed=2.25e11 * (40 - i),
                        collective_bytes=int(3e9) * (i % 7)))
    out.append(dict(arch="qwen3-32b", shape="long_500k", mesh=mesh, ok=True,
                    skipped="long_500k needs sub-quadratic attention"))
    out.append(dict(arch="qwen3-32b", shape="train_4k", mesh=mesh, ok=False))
    out.append(dict(arch="ug-index-search", shape="index", mesh=mesh, ok=True,
                    flops=2.2e10, bytes_accessed=5.1e10, collective_bytes=81920))
    return out


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_analyze_equals_the_reference(monkeypatch, mesh):
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(roofline, name, getattr(ref_roofline, name))
    want = [ref_roofline.analyze(r) for r in records(mesh)]
    assert [roofline.analyze(r) for r in records(mesh)] == want
    assert roofline.fmt_table(want) == ref_roofline.fmt_table(want)


def test_the_h100_constants():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.ICI_BW) == (989e12, 3.35e12, 50e9)
    assert roofline._CHIPS == ref_roofline._CHIPS


def test_the_cli_counts_a_full_width_cell(tmp_path, capsys):
    """``python -m repro_torch.launch.dryrun`` on a full-width cell appends
    its record, which ``launch.roofline`` reads; a cell needs an arch and
    a shape (or ``--all``/``--index-cell``)."""
    out = tmp_path / "dry.jsonl"
    assert dryrun.main(["--arch", "rwkv6-1.6b", "--shape", "long_500k", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["ok"] and rec["mesh_shape"] == {"data": 16, "model": 16}
    assert rec["loop_trip_counts"]["n_layers"] == 24 and rec["flops"] > rec["xla_flops"] > 0
    assert roofline.main([str(out)]) == 0
    assert "rwkv6-1.6b" in capsys.readouterr().out.splitlines()[-1]
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "rwkv6-1.6b"])
