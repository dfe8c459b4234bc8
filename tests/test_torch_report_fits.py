"""The cell report's ``fits`` against the card the cells run on: every
cell ``chip_smoke.py``'s phase 8 runs on one H100 (at full depth, on the
16 x 16 mesh's share of the global batch) is reported as fitting its
memory, qwen2.5-3b's train_4k (a traced peak of 81.2 GB) among them.
The capacity is the card's, 85.0 GB, not the 80 GB of its name."""
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

from repro_torch.configs import get_config, get_shape  # noqa: E402
from repro_torch.launch import report  # noqa: E402
from repro_torch.launch.mesh import HBM_BYTES  # noqa: E402


def test_capacity_is_the_cards():
    assert HBM_BYTES == 85.0e9


@pytest.mark.parametrize("arch, shape", chip_smoke.REPORT_CELLS)
def test_cells_run_on_the_card_are_reported_to_fit(arch, shape):
    art = report.report_cell(get_config(arch), get_shape(shape))
    mem = art["memory"]
    assert mem["device_bytes"] == HBM_BYTES
    assert mem["fits"], (arch, shape, mem["peak_bytes_per_device"])
    if (arch, shape) == ("qwen2.5-3b", "train_4k"):
        # above the 80 GB of the card's name, within its capacity
        assert 80e9 < mem["peak_bytes_per_device"] <= HBM_BYTES
