"""The dry-run's cells (``launch/dryrun.py``) on the reduced configs: every
arch's four cells run at small shapes of the same kinds (``run_cells``'s
test path) on the production 16×16 mesh, or are skipped by the reference's
``skip_reason``; ``roofline.main`` prints their table.  Here the decoder
family; ``tests/test_torch_dryrun_families.py`` runs the others."""
import json

import pytest
import torch

from repro.configs import registry as ref_registry
from repro_torch.configs.registry import ARCHS, SHAPES, ShapeSpec, get_arch
from repro_torch.launch import dryrun, roofline

# the four shapes' kinds at sizes the reduced configs run in well under a second
SMALL = {"train_4k": ShapeSpec("train_4k", 64, 32, "train"),
         "prefill_32k": ShapeSpec("prefill_32k", 64, 16, "prefill"),
         "decode_32k": ShapeSpec("decode_32k", 64, 32, "decode"),
         "long_500k": ShapeSpec("long_500k", 256, 1, "decode")}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


DECODERS = sorted(a for a in ARCHS if get_arch(a).config.family == "decoder")


def check_cells(arch: str, tmp_path, capsys) -> None:
    """``arch``'s four reduced cells run, or are skipped as the reference
    skips them, and the roofline prints their table."""
    out = tmp_path / "cells.jsonl"
    cells = [(arch, s, "single") for s in SHAPES]
    failures = dryrun.run_cells(cells, out=out, verbose=False, shapes=SMALL,
                                cfgs={arch: get_arch(arch).reduced})
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert failures == 0, [r.get("traceback") for r in recs if not r["ok"]]
    for rec, shape in zip(recs, SHAPES):
        skip = get_arch(arch).skip_reason(shape)
        assert skip == ref_registry.get_arch(arch).skip_reason(shape)
        assert rec["ok"] and rec.get("skipped") == skip
        if skip:
            continue
        assert rec["flops"] > 0 and rec["bytes_accessed"] > 0 and rec["collective_bytes"] > 0
        assert set(rec["mem"]) == {"temp", "argument", "output", "alias", "generated_code"}
        assert rec["mem"]["temp"] is None and rec["mem"]["argument"] > 0
    assert roofline.main([str(out)]) == 0
    table = capsys.readouterr().out.splitlines()
    assert table[0].split()[:3] == ["arch", "shape", "mesh"] and len(table) == 2 + len(SHAPES)


@pytest.mark.parametrize("arch", DECODERS)
def test_every_reduced_cell_runs_or_is_skipped(tmp_path, capsys, arch):
    check_cells(arch, tmp_path, capsys)
