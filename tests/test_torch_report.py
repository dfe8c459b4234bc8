"""The one-H100 cell report (``repro_torch.launch.report``) held against
the JAX reference's dry-run (``repro.launch.dryrun.lower_cell`` and its
HLO analysis), on the CPU.

* On tiny yi-6b, deepseek-7b and pixtral-12b, train, prefill and decode
  at a 1 x 1 mesh: the report's FLOPs outside K4 (the total less the
  flash-attention kernels' records) equal the reference's ``analyze``
  FLOPs less the dots of its blockwise attention, reckoned from its block
  sizes (``flash_attention/ops.py:46-55``: every padded block, 4 B Hq Tp
  Sp D a forward, 10 B Hq Tp Sp D a backward; at the tiny configs'
  ``remat_policy`` "none" its HLO holds one of each a layer and
  microbatch), within 2 %.  ``model_flops``, the parameter counts and
  the argument bytes (the inputs the step reads, as XLA keeps them) equal
  the reference's.
* At both production meshes, for every cell at full size, the bytes
  each device holds of every input equal the reference's shard shapes
  (``NamedSharding.shard_shape`` on a mesh of 512 forced host devices,
  in a subprocess).
* The CLI writes one JSON file a cell and the table.
"""
import dataclasses
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.launch.dryrun import lower_cell  # noqa: E402
from repro_torch.configs import get_config, get_shape, shapes_for  # noqa: E402
from repro_torch.launch import report  # noqa: E402
from repro_torch.launch.mesh import production_mesh  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
TINY = [(a, k) for a in ("yi-6b", "deepseek-7b", "pixtral-12b")
        for k in ("train", "prefill", "decode")]
SEQ, BATCH = 64, 4


def _next(x, m):
    return -(-x // m) * m


def _blockwise_dots(cfg, batch, calls_fwd, calls_bwd):
    """The reference's blockwise attention dots: every padded block of its
    ``_xla_blockwise`` (block_q 256, block_k 1024, ``ops.py:46-55``) and
    ``_xla_flash_bwd`` at T = S = the tokens after any patches."""
    t = SEQ + (cfg.num_patches if cfg.frontend == "patches" else 0)
    tp = _next(t, min(256, _next(t, 8)))
    sp = _next(t, min(1024, _next(t, 128)))
    blk = batch * cfg.num_heads * tp * sp * cfg.resolved_head_dim
    return 4 * blk * calls_fwd + 10 * blk * calls_bwd


@pytest.mark.parametrize("arch,kind", TINY, ids=[f"{a}-{k}" for a, k in TINY])
def test_flops_outside_k4_equal_the_reference(arch, kind):
    shape = ShapeConfig(f"tiny_{kind}", kind, SEQ, BATCH)
    jcfg, cfg = jax_get_config(arch, tiny=True), get_config(arch, tiny=True)
    assert jcfg.remat_policy == cfg.remat_policy == "none"
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    want = lower_cell(jcfg, shape, mesh, microbatches=0)
    got = report.report_cell(cfg, shape, mesh_shape={"data": 1, "model": 1})
    mb = got["microbatches"]
    assert mb == want["microbatches"] == (BATCH if kind == "train" else 1)

    # one K4 forward a layer and microbatch, one backward when training
    k4 = report.k4_records(got["cost"]["kernels"])
    layers = cfg.num_layers
    calls = {k: sum(v["calls"] for n, v in k4.items() if n.startswith(k))
             for k in ("flash_fwd", "flash_bwd")}
    n_fwd = 0 if kind == "decode" else layers * mb
    n_bwd = layers * mb if kind == "train" else 0
    assert calls == {"flash_fwd": n_fwd, "flash_bwd": n_bwd}

    ref_outside = want["cost"]["flops"] - _blockwise_dots(
        cfg, BATCH // mb, n_fwd, n_bwd)
    mine = got["cost"]["flops"] - sum(v["flops"] for v in k4.values())
    assert mine == got["cost"]["aten_flops"] + sum(
        v["flops"] for n, v in got["cost"]["kernels"].items()
        if n not in report.K4_KERNELS)
    assert abs(mine - ref_outside) <= 0.02 * ref_outside, (mine,
                                                           ref_outside)
    assert got["roofline"]["model_flops"] == want["roofline"]["model_flops"]
    assert got["params"] == want["params"]
    assert got["memory"]["argument_bytes"] == \
        want["memory"]["argument_bytes"]


# --------------------------------------------------------------------------
# production meshes: per-device bytes of every input at full size
# --------------------------------------------------------------------------
REF_SHARDS = textwrap.dedent("""
    import os, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import numpy as np, jax
    from repro.configs import ARCH_IDS, get_config, shapes_for
    from repro.launch.specs import cell_shardings, input_specs
    try:
        auto = dict(axis_types=(jax.sharding.AxisType.Auto,) * 3)
    except AttributeError:
        auto = {}

    def mesh(shape, names):
        kw = {k: v[:len(shape)] for k, v in auto.items()}
        return jax.make_mesh(shape, names, **kw)

    meshes = {"pod": mesh((16, 16), ("data", "model")),
              "multipod": mesh((2, 16, 16), ("pod", "data", "model"))}
    out = {}
    for arch in sorted(ARCH_IDS):
        cfg = get_config(arch)
        for shape in shapes_for(cfg):
            sds = jax.tree.leaves(input_specs(cfg, shape))
            for name, m in meshes.items():
                sh = jax.tree.leaves(cell_shardings(cfg, shape, m),
                                     is_leaf=lambda x: hasattr(x, "spec"))
                assert len(sh) == len(sds)
                out[f"{arch}/{shape.name}/{name}"] = sum(
                    int(np.prod(s.shard_shape(x.shape)))
                    * np.dtype(x.dtype).itemsize for x, s in zip(sds, sh))
    print(json.dumps(out))
""")
CELLS = [(a, s.name, m) for a in sorted(ARCH_IDS)
         for s in shapes_for(get_config(a)) for m in ("pod", "multipod")]


@pytest.fixture(scope="module")
def reference_shard_bytes():
    proc = subprocess.run([sys.executable, "-c", REF_SHARDS],
                          capture_output=True, text=True, timeout=600,
                          cwd=str(SRC))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch,shape,mesh", CELLS,
                         ids=[f"{a}-{s}-{m}" for a, s, m in CELLS])
def test_argument_bytes_per_device_equal_the_reference(
        arch, shape, mesh, reference_shard_bytes):
    got = report.argument_bytes(get_config(arch), get_shape(shape),
                                production_mesh(mesh == "multipod"))
    assert got["per_device"] == reference_shard_bytes[
        f"{arch}/{shape}/{mesh}"]


# --------------------------------------------------------------------------
# the CLI and the measurement on the CPU
# --------------------------------------------------------------------------
def test_cli_writes_a_cell_and_the_table(tmp_path, capsys):
    assert report.main(["--arch", "yi-6b", "--shape", "decode_32k",
                        "--both-meshes", "--tops", "3",
                        "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert report.TABLE_HEAD.splitlines()[0] in out
    assert "top flops" in out
    for name in ("pod", "multipod"):
        art = json.loads((tmp_path / f"yi-6b__decode_32k__{name}.json")
                         .read_text())
        assert art["device_batch"] == 128 // (16 if name == "pod" else 32)
        assert art["memory"]["fits"] and art["kind"] == "decode"
        assert art["roofline"]["bound_s"] > 0
        # decode reads every weight but the frontend's (yi has none) and
        # the whole cache
        assert art["memory"]["unread_inputs"] == []


def test_measure_on_the_cpu_counts_the_plain_path():
    cfg = dataclasses.replace(get_config("yi-6b", tiny=True), num_layers=1)
    shape = ShapeConfig("tiny_train", "train", 32, 4)
    m = report.measure_cell(cfg, shape, batch=4, microbatches=2,
                            device="cpu")
    report.check_measure(m)            # the CPU's run is not held to it
    # the plain attention runs as aten ops on the CPU: no K4 record, its
    # products counted with the rest
    assert m["kernels"] == {} and m["k4_launches"] == 0
    assert {n: v["calls"] for n, v in m["meta_kernels"].items()} == {
        "flash_fwd": 2, "flash_bwd": 2}
    assert m["flops"] > m["meta_flops"] - sum(
        v["flops"] for v in m["meta_kernels"].values())
    assert m["ms"] > 0 and m["max_memory_allocated"] is None
