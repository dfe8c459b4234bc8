"""The port stands alone: it loads no jax, no ml_dtypes and nothing of
``repro``; its copies of the framework-neutral modules have not drifted
from the reference's; and the copied checkpoint service works on its own.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"

# (reference module, port copy) pairs carried over verbatim but for import
# paths; the port's blocks.py also drops the ml_dtypes import below
COPIES = (
    [(p, SRC / "repro_torch" / "core" / p.name)
     for p in sorted((SRC / "repro" / "core").glob("*.py"))
     if p.name != "snapshot.py"]
    + [(p, SRC / "repro_torch" / "core" / "services" / p.name)
       for p in sorted((SRC / "repro" / "core" / "services").glob("*.py"))]
    + [(p, SRC / "repro_torch" / "obs" / p.name)
       for p in sorted((SRC / "repro" / "obs").glob("*.py"))]
    + [(SRC / "repro" / "kernels" / "ckpt_codec" / n,
        SRC / "repro_torch" / "kernels" / "ckpt_codec" / n)
       for n in ("blocks.py", "rs.py")]
    + [(SRC / "repro" / "configs" / n, SRC / "repro_torch" / "configs" / n)
       for n in ("__init__.py", "base.py", "yi_6b.py", "qwen2_5_3b.py")]
)
ML_DTYPES_IMPORT = '''try:  # np.dtype("bfloat16") — registered by jax's ml_dtypes dependency
    import ml_dtypes  # noqa: F401
except Exception:  # pragma: no cover - optional
    pass

'''


def test_port_imports_no_jax_and_nothing_of_repro():
    script = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = ["repro_torch"]
        for info in pkgutil.walk_packages(repro_torch.__path__,
                                          "repro_torch."):
            names.append(info.name)
        for name in names:
            importlib.import_module(name)
        loaded = [m for m, mod in sys.modules.items() if mod is not None]
        bad = sorted(m for m in loaded
                     if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes",
                                            "repro"))
        assert not bad, bad
        print(len(names))
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(SRC),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 40       # every module was imported


@pytest.mark.parametrize("ref,copy", COPIES,
                         ids=[str(c.relative_to(SRC)) for _, c in COPIES])
def test_copies_have_not_drifted(ref, copy):
    want = ref.read_text().replace(ML_DTYPES_IMPORT, "")
    got = copy.read_text().replace("repro_torch.", "repro.")
    assert got == want, f"{copy} drifted from {ref}"


def test_commit_drain_restart_bit_identical(tmp_path):
    from repro_torch.core import (ICheckCluster, ICheckClient,
                                  PartitionScheme, ResourceManager,
                                  split_array)
    from repro_torch.core.controller import Controller
    from repro_torch.core.types import CkptStatus, PartitionDesc

    data = np.random.default_rng(0).standard_normal((64, 9)).astype(
        np.float32)
    desc = PartitionDesc(scheme=PartitionScheme.BLOCK, num_parts=2)
    parts = dict(enumerate(split_array(data, desc)))
    with ICheckCluster(n_icheck_nodes=2, node_memory=64 << 20,
                       pfs_root=str(tmp_path / "pfs")) as cluster:
        client = ICheckClient("app", cluster.controller, ranks=2).init()
        client.add_adapt("data", data.shape, "float32",
                         scheme=PartitionScheme.BLOCK, num_parts=2)
        h = client.commit(step=3, parts_by_region={"data": parts},
                          blocking=True)
        cluster.controller.wait_for_drains()
        assert h.meta.status == CkptStatus.IN_L2
        client.finalize()

        rm2 = ResourceManager()
        rm2.make_node()
        ctl2 = Controller(rm2, cluster.pfs, initial_nodes=1)
        try:
            client2 = ICheckClient("app", ctl2, ranks=2).init()
            meta, got, level = client2.restart()
            assert level == "l2" and meta.step == 3
            back = np.concatenate([got["data"][i] for i in range(2)])
            assert back.tobytes() == data.tobytes()
            client2.finalize()
        finally:
            ctl2.close()
