"""The cell report on both production meshes at full size: every cell
that the library splits is traced as rank 0 of the mesh (26 cells a
mesh: its boxes, the library's split step in a one-process world of the
mesh's ranks on the ``fake`` backend, its collectives traced and none
reckoned, the model's FLOPs shared over every device); the 6 cells a
mesh of seamless-m4t-medium and pixtral-12b, which
``check_model_axis`` does not let split yet, keep one device's
data-parallel step, labelled with the check's message.  The serving
cells of the models whose kv heads 16 does not divide hold their cache
over its sequence.

The traces run in subprocesses (a process holds one default group), the
cells dealt to ``WORKERS`` of them by their trace time on this CPU (a
MoE model's training cell takes minutes: one broadcast a data rank for
each leaf of each layer of each microbatch's forward, remat and
backward)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, get_config, shapes_for  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CELLS = [(a, s.name, mp) for a in sorted(ARCH_IDS)
         for s in shapes_for(get_config(a)) for mp in (False, True)]
UNSPLIT = ("seamless-m4t-medium", "pixtral-12b")
WORKERS = 4

TRACE = r"""
import json, sys
sys.path.insert(0, "src")
from repro_torch.configs import get_config, shapes_for
from repro_torch.launch import report

out = {}
for arch, shape_name, multipod in json.loads(sys.argv[1]):
    cfg = get_config(arch)
    shape = [s for s in shapes_for(cfg) if s.name == shape_name][0]
    art = report.report_cell(cfg, shape, multi_pod=multipod)
    out[f"{arch}/{shape_name}/{int(multipod)}"] = {
        "split": art["split"], "unsplit": art["unsplit"],
        "fits": art["memory"]["fits"],
        "counts": art["collectives"]["counts"],
        "reckoned": "reckoned" in art["collectives"],
        "per_device": art["roofline"]["model_flops_per_device"],
        "model_flops": art["roofline"]["model_flops"],
        "chips": art["chips"]}
print("RESULT " + json.dumps(out))
"""


def _cost(cell):
    """A cell's trace time on this CPU, in units of about 4 s: qwen3-moe's
    training cell (94 layers) longest, then dbrx-132b's, then the other
    training cells and the MoE serving ones."""
    arch, shape, _ = cell
    moe = "moe" in arch or "dbrx" in arch
    if shape != "train_4k":
        return 3 if moe else 1
    if moe:
        return 50 if "moe" in arch else 20
    return 8


def _deal(cells, n):
    """``cells`` in ``n`` groups of about equal cost, longest first."""
    groups = [[] for _ in range(n)]
    load = [0] * n
    for cell in sorted(cells, key=_cost, reverse=True):
        i = load.index(min(load))
        groups[i].append(cell)
        load[i] += _cost(cell)
    return groups


@pytest.fixture(scope="module")
def traced():
    procs = [subprocess.Popen(
        [sys.executable, "-c", TRACE, json.dumps([list(c) for c in group])],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for group in _deal(CELLS, WORKERS)]
    out = {}
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=1500)
        lines = [ln for ln in stdout.splitlines() if ln.startswith("RESULT ")]
        assert proc.returncode == 0 and lines, stdout[-3000:] + stderr[-5000:]
        out.update(json.loads(lines[-1][len("RESULT "):]))
    return out


def test_every_split_cell_is_traced_as_a_rank_of_the_mesh(traced):
    split = [k for k, v in traced.items() if v["split"] is not None]
    assert len(traced) == 64 and len(split) == 52
    for key, art in traced.items():
        arch = key.split("/")[0]
        if arch in UNSPLIT:
            assert art["split"] is None and "not split" in art["unsplit"]
            continue
        assert art["unsplit"] is None
        assert art["split"]["ranks"] == {
            "data": 32 if key.endswith("/1") else 16, "model": 16}
        assert not art["reckoned"]
        assert art["per_device"] == art["model_flops"] / art["chips"]
        # every split step talks over "model"
        assert art["counts"]["all-reduce"] > 0, key


def test_serving_cells_hold_the_cache_over_its_sequence(traced):
    """deepseek-7b's 32 kv heads split by heads; rwkv6-7b has no KV
    cache; the other splittable models' serving cells go over
    ``kv_seq``, recurrentgemma-9b's 2048-slot rings too."""
    for key, art in traced.items():
        arch, shape, _ = key.split("/")
        if art["split"] is None:
            continue
        cfg = get_config(arch)
        want = shape != "train_4k" and cfg.mixer != "rwkv6" and \
            cfg.num_kv_heads % 16 != 0
        assert art["split"]["kv_seq"] == want, key


def test_the_split_cells_fit_the_card(traced):
    """Traced per device, every split cell fits the card's 85.0 GB."""
    over = [k for k, v in traced.items()
            if v["split"] is not None and not v["fits"]]
    assert over == [], over
