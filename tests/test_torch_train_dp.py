"""The port's data-parallel ``ElasticTrainer`` over a real process world (2
CPU processes in a gloo world, ``torch_dp_workers.py``) held against the
reference ``ElasticTrainer`` on 2 forced host devices (a subprocess).

* Tiny qwen2.5-3b and tiny qwen3-moe-235b-a22b, the latter also under
  ``FSDP_RULES`` as its full config names (``"qwen3-moe-235b-a22b:fsdp"``:
  the trainer keeps every leaf whole on its "data" mesh, as the
  reference's does, so nothing is gathered), global batch 4, from the
  reference's initial state (carried across by leaf name): 3 steps on 1
  rank, a resize to 2 ranks (rank 1 joins and receives the state from
  rank 0), 3 steps, a resize back to 1 (rank 1 frees its state), 3 steps,
  committing every 2.  Losses rtol 1e-5, and the final params and moments
  within the tolerance of ``tests/test_torch_train.py``'s train-step test
  (rtol 1e-5, each leaf atol 1e-6 of its largest value, but for at most
  1e-3 of a leaf's elements (one, for the MoE model), held to the size of
  the steps taken).  While on 2 ranks, both replicas stay bit-equal.
* A global batch whose label masks differ between the two ranks' halves
  (12 of 15 targets masked in the first, none in the second): the
  data-parallel loss and all-reduced gradient match ``jax.value_and_grad``
  of the reference's loss on the whole batch (rtol 1e-5, each leaf atol
  1e-6 of its largest gradient, ``tests/test_torch_train.py``'s), and two
  data-parallel steps' losses its train step's (rtol 1e-5): the masked
  mean over the whole batch, not the mean of the halves' means (which
  this batch moves well beyond rtol).
* A restart across rank counts: 3 steps on 2 ranks and a commit, then a
  new trainer on 1 rank restarts from it and takes 3 more, matching the
  reference's uninterrupted run.
"""
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import loss_fn as jax_loss_fn  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import warmup_cosine as jax_warmup_cosine  # noqa: E402
from repro.core.snapshot import leaf_names as jax_leaf_names  # noqa: E402
from repro.train import make_train_state as jax_make_train_state  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import loss_fn  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402

import torch_dp_workers as workers  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen2.5-3b", "qwen3-moe-235b-a22b"]
# an arch, or "arch:rules" for its tiny config under other rules
TRAINER_CASES = ARCHS + ["qwen3-moe-235b-a22b:fsdp"]
# (steps, resize to after them)
PLAN = [(3, 2), (3, 1), (3, None)]
COMMIT_EVERY = 2
# the learning rates of the 9 steps, warmup 20 from lr 1e-3: their sum
# bounds how far one element can walk (AdamW's steps are at most ~lr)
STEPS_LR = sum(1e-3 * min(s / 20, 1.0) for s in range(1, 10))

REFERENCE = r"""
import dataclasses, os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import numpy as np
import jax
sys.path.insert(0, "src")
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.core import ICheckCluster
from repro.core.snapshot import leaf_names
from repro.optim import AdamWConfig
from repro.train.elastic import ElasticTrainer

out, archs, plan, commit_every, seq, gb = pickle.loads(bytes.fromhex(
    sys.argv[1]))
res = {}


def arrays(state):
    return dict(zip(leaf_names(state),
                    [np.asarray(x) for x in jax.tree.leaves(state)]))


for arch in archs:
    name, _, rules = arch.partition(":")
    cfg = get_config(name, tiny=True)
    if rules:
        cfg = dataclasses.replace(cfg, rules=rules)
    with ICheckCluster(n_icheck_nodes=2) as cluster:
        t = ElasticTrainer(cfg,
                           ShapeConfig("t", "train", seq, gb), cluster,
                           app_id="app", ranks=1, seed=0,
                           opt_cfg=AdamWConfig(lr=1e-3), probe_every=0,
                           global_batch=gb, commit_every=commit_every)
        init = arrays(t.state)
        sizes = []
        for steps, new in plan:
            t.run(steps)
            sizes.append(t.mesh.devices.size)
            if new:
                cluster.rm.schedule_resize("app", new)
        res[arch] = {"init": init, "final": arrays(t.state),
                     "losses": [m["loss"] for m in t.metrics_log],
                     "sizes": sizes, "devices": len(jax.devices())}
        t.finalize()
with open(out, "wb") as f:
    pickle.dump(res, f)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "ref.pkl"
    arg = pickle.dumps((str(out), TRAINER_CASES, PLAN, COMMIT_EVERY, workers.SEQ,
                        workers.GLOBAL_BATCH)).hex()
    proc = subprocess.run([sys.executable, "-c", REFERENCE, arg],
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=600)
    assert "REFERENCE_OK" in proc.stdout, proc.stdout + proc.stderr
    with open(out, "rb") as f:
        return pickle.load(f)


def _assert_state_close(got, want, arch, steps_lr, prefixes=("params",
                                                             "opt/mu",
                                                             "opt/nu")):
    """``tests/test_torch_train.py``'s train-step tolerance, leaf by leaf."""
    dense = get_config(arch.partition(":")[0], tiny=True).family == "dense"
    for name, w in want.items():
        if not name.startswith(prefixes):
            continue
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        far = ~np.isclose(g, w, rtol=1e-5,
                          atol=1e-6 * max(np.abs(w).max(), 1e-30))
        allowed = 1e-3 * far.size if dense else max(1e-3 * far.size, 1)
        assert far.sum() <= allowed or name.endswith("attn/bkv"), name
        np.testing.assert_allclose(g, w, atol=steps_lr, err_msg=name)


@pytest.mark.parametrize("arch", TRAINER_CASES)
def test_dp_trainer_with_resizes_matches_reference(reference, arch,
                                                   tmp_path):
    ref = reference[arch]
    assert ref["devices"] == 2 and ref["sizes"] == [1, 2, 1]
    got = workers.spawn_world(workers.trainer_resize, 2, tmp_path, arch,
                              ref["init"], PLAN, COMMIT_EVERY)
    assert got["sizes"] == [1, 2, 1] and got["resizes"] == 2
    assert got["ranks"] == 1 and got["replicas_equal"]
    assert int(got["state"]["step"]) == int(ref["final"]["step"]) == 9
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    _assert_state_close(got["state"], ref["final"], arch, STEPS_LR)


def _uneven_batch(cfg, seed=3, b=4, t=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    labels = toks.copy()
    labels[: b // 2, 4:] = -1          # the first rank's half: 3 targets a row
    return {"tokens": toks, "labels": labels}


@pytest.mark.parametrize("arch", ARCHS)
def test_uneven_masks_take_the_global_token_mean(arch, tmp_path):
    jcfg, cfg = jax_get_config(arch, tiny=True), get_config(arch, tiny=True)
    jopt = JaxAdamWConfig(lr=1e-3)
    jstate = jax_make_train_state(jcfg, jax.random.key(2), jopt)
    init = dict(zip(jax_leaf_names(jstate),
                    [np.asarray(x) for x in jax.tree.leaves(jstate)]))
    batch = _uneven_batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jax_loss_fn(jcfg, p, jbatch, impl="xla"),
        has_aux=True)(jstate.params)
    jstep = jax.jit(jax_make_train_step(jcfg, jopt,
                                        jax_warmup_cosine(1e-3, 2, 10),
                                        impl="xla"))
    jlosses = []
    for _ in range(2):
        jstate, jm = jstep(jstate, jbatch)
        jlosses.append(float(jm["loss"]))
    got = workers.spawn_world(workers.dp_grads, 2, tmp_path, arch, init,
                              batch, 2)
    np.testing.assert_allclose(got["loss"], float(jloss), rtol=1e-5)
    want = dict(zip(jax_leaf_names(jgrads),
                    [np.asarray(x) for x in jax.tree.leaves(jgrads)]))
    assert sorted(got["grads"]) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(
            got["grads"][name], w, rtol=1e-5,
            atol=1e-6 * max(np.abs(w).max(), 1e-30), err_msg=name)
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5)
    # the mean of the halves' own means is another number
    params = _nest(params_from_numpy(
        {k[len("params/"):]: v for k, v in init.items()
         if k.startswith("params/")}, "cpu"))
    halves = [float(loss_fn(cfg, params, {k: torch.from_numpy(v[i:i + 2])
                                          for k, v in batch.items()})[0])
              for i in (0, 2)]
    assert abs(np.mean(halves) - float(jloss)) > 1e-3 * abs(float(jloss))


def _nest(flat):
    """{"a/b/c": x} -> {"a": {"b": {"c": x}}}."""
    out = {}
    for name, v in flat.items():
        node = out
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def test_restart_across_rank_counts(reference, tmp_path):
    arch = "qwen2.5-3b"
    ref = reference[arch]
    got = workers.spawn_world(workers.trainer_restart_across_ranks, 2,
                              tmp_path, arch, ref["init"], 3)
    assert got["restarted"] and got["mesh"] == 1
    # the reference's 6 first steps: 3 on 1 device, 3 on 2
    np.testing.assert_allclose(got["losses"], ref["losses"][:6], rtol=1e-5)
    assert int(got["state"]["step"]) == 6
