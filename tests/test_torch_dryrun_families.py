"""The dry-run's reduced cells of the families outside the decoder
(rwkv6, zamba2, encdec): ``tests/test_torch_dryrun_cells.py``'s check."""
import pytest

from repro_torch.configs.registry import ARCHS
from test_torch_dryrun_cells import DECODERS, check_cells, one_torch_thread  # noqa: F401

OTHERS = sorted(set(ARCHS) - set(DECODERS))


@pytest.mark.parametrize("arch", OTHERS)
def test_every_reduced_cell_runs_or_is_skipped(tmp_path, capsys, arch):
    check_cells(arch, tmp_path, capsys)
