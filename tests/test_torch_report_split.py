"""The cell report traced as rank 0 of a mesh (``repro_torch.launch.
report``: the rank's boxes, the library's split step in a one-process
world on the ``fake`` backend, the collectives traced) against the JAX
reference's dry-run of the partitioned program (``repro.launch.dryrun.
lower_cell`` and its HLO analysis, per device), on the CPU.

* On tiny yi-6b, qwen2.5-3b, phi3-medium-14b, recurrentgemma-9b and
  qwen3-moe (under ``FSDP_RULES``), train, prefill and decode on
  ("data", "model") meshes of (1, 2), (1, 4) and (2, 2): the report's
  FLOPs outside K4 (its total less the flash-attention kernels' records)
  are within 2 % of the reference's per-device ``analyze`` FLOPs less
  the dots of its blockwise attention on a device's share of the
  queries (``flash_attention/ops.py:46-55``), and the argument bytes per
  device are equal.  The per-device peak and collective bytes are
  printed beside the reference's and not held: GSPMD rematerializes
  (prefill at (1, 4) logs XLA's "Involuntary full rematerialization")
  and picks its own collectives, where the port issues the ones its
  layers name.
* Tiny seamless-m4t-medium, pixtral-12b and yi-6b with the int8 cache
  (``check_model_axis`` raises for each) keep one device's data-parallel
  step, labelled unsplit with the check's message.
* ``fake_store``, the one import of torch's private ``fake`` backend:
  a store where torch has it, else a ``RuntimeError`` naming torch's
  version.
* ``--measure`` of a split serving rank runs it beside its "model" peers
  in a gloo world and holds its counts to the trace; a training cell at
  "data" > 1 is refused.

Both sides run in subprocesses: the reference on 4 forced host devices,
the port because its trace owns the process's default group.  The
production meshes at full size are ``test_torch_report_split_full.py``'s;
``check_model_axis``'s raises for what is still unsplit,
``test_torch_kv_seq.py``'s.
"""
import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = {"yi-6b": {}, "qwen2.5-3b": {}, "phi3-medium-14b": {},
         "recurrentgemma-9b": {}, "qwen3-moe-235b-a22b": {"rules": "fsdp"}}
MESHES = [(1, 2), (1, 4), (2, 2)]
KINDS = ("train", "prefill", "decode")
SEQ, BATCH = 64, 4
CASES = [(m, a, k) for m in MESHES for a in ARCHS for k in KINDS]
CASE_IDS = [f"{m[0]}x{m[1]}-{a}-{k}" for m, a, k in CASES]

REFERENCE = r"""
import os, json, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax
from jax.sharding import Mesh
sys.path.insert(0, "src")
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.launch.dryrun import lower_cell

cases, seq, batch = json.loads(sys.argv[1])
out = {}
for (d, m), arch, over, kind in cases:
    cfg = dataclasses.replace(get_config(arch, tiny=True), **over)
    mesh = Mesh(np.asarray(jax.devices()[:d * m]).reshape(d, m),
                ("data", "model"))
    art = lower_cell(cfg, ShapeConfig(f"tiny_{kind}", kind, seq, batch),
                     mesh, microbatches=0)
    out[f"{d}x{m}/{arch}/{kind}"] = {
        "flops": art["cost"]["flops"],
        "argument_bytes": art["memory"]["argument_bytes"],
        "peak": art["memory"]["peak_bytes_per_device"],
        "link": art["collectives"]["total_link_bytes"],
        "microbatches": art["microbatches"]}
print("RESULT " + json.dumps(out))
"""

PORT = r"""
import json, sys, dataclasses
sys.path.insert(0, "src")
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import report

cases, seq, batch = json.loads(sys.argv[1])
out = {}
for (d, m), arch, over, kind in cases:
    cfg = dataclasses.replace(get_config(arch, tiny=True), **over)
    art = report.report_cell(cfg, ShapeConfig(f"tiny_{kind}", kind, seq,
                                              batch),
                             mesh_shape={"data": d, "model": m})
    k4 = report.k4_records(art["cost"]["kernels"])
    out[f"{d}x{m}/{arch}/{kind}"] = {
        "flops": art["cost"]["flops"],
        "k4_flops": sum(v["flops"] for v in k4.values()),
        "k4_calls": {n: v["calls"] for n, v in k4.items()},
        "argument_bytes": art["memory"]["argument_bytes"],
        "peak": art["memory"]["peak_bytes_per_device"],
        "link": art["collectives"]["total_link_bytes"],
        "reckoned": "reckoned" in art["collectives"],
        "split": art["split"], "unsplit": art["unsplit"],
        "microbatches": art["microbatches"],
        "device_batch": art["device_batch"]}
print("RESULT " + json.dumps(out))
"""

def _run(script, arg, timeout):
    proc = subprocess.run([sys.executable, "-c", script, json.dumps(arg)],
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=timeout)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RESULT ")]
    assert proc.returncode == 0 and lines, proc.stdout[-3000:] + \
        proc.stderr[-5000:]
    return json.loads(lines[-1][len("RESULT "):])


def _arg():
    return [[[list(m), a, ARCHS[a], k] for m, a, k in CASES], SEQ, BATCH]


@pytest.fixture(scope="module")
def reference():
    return _run(REFERENCE, _arg(), 1200)


@pytest.fixture(scope="module")
def port():
    return _run(PORT, _arg(), 1200)


def _next(x, m):
    return -(-x // m) * m


def _blockwise_dots(cfg, mesh, kind, microbatches, layers):
    """The reference's blockwise attention dots on one device (block_q
    256, block_k 1024, ``ops.py:46-55``; every padded block, 4 B Hq Tp Sp
    D a forward, 10 B Hq Tp Sp D a backward, one of each a layer and
    microbatch at the tiny configs' ``remat_policy``): its rows of the
    batch, and a "model" rank's share of the rest where "model" divides
    the query heads or, in prefill, the KV sequence goes over "model"
    (GSPMD splits the attention's blocks along it)."""
    if kind == "decode":
        return 0
    d, m = mesh
    b = BATCH // d // microbatches if BATCH % d == 0 else BATCH
    heads = cfg.num_heads
    if cfg.num_heads % m == 0 or (kind == "prefill"
                                  and cfg.num_kv_heads % m != 0):
        heads /= m
    tp = _next(SEQ, min(256, _next(SEQ, 8)))
    sp = _next(SEQ, min(1024, _next(SEQ, 128)))
    blk = b * heads * tp * sp * cfg.resolved_head_dim
    calls = layers * microbatches
    return 4 * blk * calls + (10 * blk * calls if kind == "train" else 0)


def _attention_layers(cfg):
    if cfg.mixer == "rglru_hybrid":
        from repro_torch.models.transformer import stack_plan

        plan = stack_plan(cfg)
        return plan["scan_kinds"].count("attn") * plan["scan_len"] + \
            plan["tail_kinds"].count("attn")
    return cfg.num_layers


@pytest.mark.parametrize("mesh,arch,kind", CASES, ids=CASE_IDS)
def test_flops_outside_k4_per_device_match_the_reference(
        reference, port, mesh, arch, kind):
    key = f"{mesh[0]}x{mesh[1]}/{arch}/{kind}"
    got, want = port[key], reference[key]
    cfg = dataclasses.replace(get_config(arch, tiny=True), **ARCHS[arch])
    assert got["unsplit"] is None and got["split"]["ranks"] == {
        "data": mesh[0], "model": mesh[1]}
    assert not got["reckoned"]
    assert got["microbatches"] == want["microbatches"]
    # the serving cells' cache goes over "kv_seq" where the kv heads do
    # not divide "model"
    assert got["split"]["kv_seq"] == (
        kind != "train" and cfg.num_kv_heads % mesh[1] != 0)
    layers = _attention_layers(cfg)
    mb = got["microbatches"]
    n_fwd = 0 if kind == "decode" else layers * mb
    calls = {k: sum(v for n, v in got["k4_calls"].items()
                    if n.startswith(k)) for k in ("flash_fwd", "flash_bwd")}
    assert calls == {"flash_fwd": n_fwd,
                     "flash_bwd": n_fwd if kind == "train" else 0}
    ref_outside = want["flops"] - _blockwise_dots(cfg, mesh, kind, mb,
                                                  layers)
    mine = got["flops"] - got["k4_flops"]
    print(f"{key}: flops outside K4 {mine:.6g} vs {ref_outside:.6g}; "
          f"peak {got['peak']} vs {want['peak']}; link bytes "
          f"{got['link']:.6g} vs {want['link']:.6g}")
    assert abs(mine - ref_outside) <= 0.02 * ref_outside, (mine,
                                                           ref_outside)
    assert got["argument_bytes"] == want["argument_bytes"]


UNSPLIT_CASES = [("seamless-m4t-medium", "prefill", False),
                 ("pixtral-12b", "train", False),
                 ("yi-6b", "decode", True)]


@pytest.mark.parametrize("arch,kind,kv_quant", UNSPLIT_CASES,
                         ids=[f"{a}-{k}{'-int8' if q else ''}"
                              for a, k, q in UNSPLIT_CASES])
def test_cells_not_split_yet_keep_the_data_parallel_trace(arch, kind,
                                                          kv_quant):
    """The encoder-decoder, the patches frontend and the int8 cache
    (``check_model_axis`` raises for each) keep one device's step at the
    data ranks' share of the batch, labelled: ``split`` None beside the
    check's message, a training cell's data-parallel all-reduce
    reckoned.  No process group is made, so this runs in the test's
    process."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import report

    shape = ShapeConfig(f"tiny_{kind}", kind, SEQ, BATCH)
    art = report.report_cell(get_config(arch, tiny=True), shape,
                             kv_quant=kv_quant,
                             mesh_shape={"data": 2, "model": 2})
    assert art["split"] is None and "not split" in art["unsplit"]
    assert ("int8" in art["unsplit"]) == kv_quant
    assert art["device_batch"] == BATCH // 2
    assert ("reckoned" in art["collectives"]) == (kind == "train")
    assert "| no |" in report.table_row(art)


MEASURE = r"""
import json, sys
sys.path.insert(0, "src")
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import report

if __name__ == "__main__":
    cfg = get_config("qwen2.5-3b", tiny=True)
    mesh = {"data": 2, "model": 4}
    shape = ShapeConfig("tiny_decode", "decode", 64, 4)
    art = report.report_cell(cfg, shape, mesh_shape=mesh)
    m = report.measure(cfg, shape, art, device="cpu")
    train = ShapeConfig("tiny_train", "train", 64, 4)
    try:
        report.measure(cfg, train, report.report_cell(cfg, train,
                                                      mesh_shape=mesh),
                       device="cpu")
        refused = None
    except ValueError as e:
        refused = str(e)
    print("RESULT " + json.dumps({
        k: m[k] for k in ("flops", "meta_flops", "bytes", "meta_bytes",
                          "collectives", "meta_collectives", "sequences",
                          "kernels", "meta_kernels")} | {"refused": refused}))
"""


def test_measure_runs_a_split_rank_beside_its_model_peers(tmp_path):
    """``--measure`` of a split serving cell: rank 0 of ("data" 2,
    "model" 4) runs in a gloo world of its 4 "model" peers (here on the
    CPU), and its counts are held to the trace: a decode step launches no
    kernel, so even its FLOPs and bytes equal the ``meta`` trace's on the
    CPU.  A training cell, which talks over "data", is refused."""
    script = tmp_path / "measure.py"
    script.write_text(MEASURE)
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, cwd=ROOT, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RESULT ")]
    assert proc.returncode == 0 and lines, proc.stdout[-3000:] + \
        proc.stderr[-5000:]
    got = json.loads(lines[-1][len("RESULT "):])
    assert got["sequences"] == 2
    assert got["collectives"] == got["meta_collectives"]
    assert got["collectives"]["counts"]["all-reduce"] > 0
    assert (got["flops"], got["bytes"]) == (got["meta_flops"],
                                            got["meta_bytes"])
    assert got["kernels"] == got["meta_kernels"] == {}
    assert "data ranks" in got["refused"]


def test_fake_store_is_the_one_import_of_the_fake_backend(monkeypatch):
    import torch
    import torch.distributed as dist

    from repro_torch.launch import report

    assert isinstance(report.fake_store(), dist.Store)
    monkeypatch.setitem(sys.modules,
                        "torch.testing._internal.distributed.fake_pg", None)
    with pytest.raises(RuntimeError, match=re.escape(
            f"torch {torch.__version__} has no 'fake' process-group "
            f"backend")):
        report.fake_store()
