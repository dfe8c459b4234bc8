"""The port's ``ElasticTrainer`` options held against the reference trainer
on the CPU: the adaptive checkpoint interval (``adaptive_interval`` with
``step_sim_s``), ``replication`` and ``global_batch``.

Both trainers run tiny qwen2.5-3b from the same state (the reference's,
carried across by ``train_state_from_numpy``) on the same synthetic data,
each on a cluster of its own.  Losses agree to rtol 1e-5, the tolerance of
the port's other trainer twins (``tests/test_torch_train.py``); commit
steps, ``interval_changes``, catalog replicas and batch shapes are equal.

The cadence is pinned: the clusters run with ``adaptive_interval=False``,
so no solver re-paces the apps from commit-cost telemetry (which need not
repeat from run to run), and the interval changes by one
``INTERVAL_CHANGED`` published on the bus mid-run.  Commits advance the
sim clock too (the simulated links sleep on it), by microseconds at this
size; the steps' 1 s and the intervals' half-second margins keep those
from moving a commit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShapeConfig  # noqa: E402
from repro.core import ICheckCluster as JaxICheckCluster  # noqa: E402
from repro.core import events as jax_events  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.train import ElasticTrainer as JaxElasticTrainer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.convert import train_state_from_numpy  # noqa: E402
from repro_torch.core import ICheckCluster  # noqa: E402
from repro_torch.core import events  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train import ElasticTrainer  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False

ARCH = "qwen2.5-3b"
CPU = torch.device("cpu")
SEQ, GLOBAL_BATCH = 32, 4
# sim seconds a step; the interval before and after the mid-run change
STEP_SIM_S, INTERVAL_S, NEW_INTERVAL_S = 1.0, 2.5, 1.5
FIRST, SECOND = 7, 6                    # steps before and after the change


def _pair(cluster, jcluster, **kw):
    """The reference trainer and the port's, from the reference's state."""
    kw = dict(app_id="app", seed=3, probe_every=0, total_steps=16, **kw)
    jt = JaxElasticTrainer(jax_get_config(ARCH, tiny=True),
                           JaxShapeConfig("t", "train", SEQ, GLOBAL_BATCH),
                           jcluster, opt_cfg=JaxAdamWConfig(lr=1e-3), **kw)
    t = ElasticTrainer(get_config(ARCH, tiny=True),
                       ShapeConfig("t", "train", SEQ, GLOBAL_BATCH), cluster,
                       opt_cfg=AdamWConfig(lr=1e-3), device=CPU, **kw)
    t.state = train_state_from_numpy(jax.tree.map(np.asarray, jt.state), CPU)
    return jt, t


def _record_commits(trainer):
    """The steps at which ``trainer`` commits, as a list it appends to."""
    steps, commit = [], trainer.commit

    def recorded(*a, **kw):
        steps.append(int(trainer.state.step))
        return commit(*a, **kw)
    trainer.commit = recorded
    return steps


def _losses(trainer):
    return [m["loss"] for m in trainer.metrics_log]


def test_adaptive_interval_follows_the_announced_interval():
    with ICheckCluster(n_icheck_nodes=2, adaptive_interval=False) as cl, \
            JaxICheckCluster(n_icheck_nodes=2,
                             adaptive_interval=False) as jcl:
        jt, t = _pair(cl, jcl, adaptive_interval=True,
                      step_sim_s=STEP_SIM_S, commit_every=1)
        out = {}
        for name, tr, c, ev in (("ref", jt, jcl, jax_events),
                                ("port", t, cl, events)):
            steps = _record_commits(tr)
            tr.client.ckpt_interval_s = INTERVAL_S
            tr.run(FIRST)
            c.controller.bus.publish(ev.INTERVAL_CHANGED, app="app",
                                     interval_s=NEW_INTERVAL_S,
                                     prev_interval_s=INTERVAL_S)
            # another app's announcement is not this trainer's
            c.controller.bus.publish(ev.INTERVAL_CHANGED, app="other",
                                     interval_s=0.1,
                                     prev_interval_s=INTERVAL_S)
            res = tr.run(SECOND)
            out[name] = (steps, tr.interval_changes,
                         res["interval_changes"], res["ckpt_interval_s"],
                         _losses(tr))
            tr.finalize()
    steps, changes, res_changes, interval, losses = out["port"]
    # 2.5 s at 1 s a step: every third step; from step 7 on 1.5 s: every
    # second
    assert steps == out["ref"][0] == [3, 6, 8, 10, 12]
    assert changes == res_changes == out["ref"][1] == 1
    assert interval == out["ref"][3] == NEW_INTERVAL_S
    np.testing.assert_allclose(losses, out["ref"][4], rtol=1e-5)


def test_static_cadence_ignores_the_sim_clock():
    """Without ``adaptive_interval`` commits follow ``commit_every``,
    whatever the sim clock and the announced interval say."""
    with ICheckCluster(n_icheck_nodes=2, adaptive_interval=False) as cl:
        t = ElasticTrainer(get_config(ARCH, tiny=True),
                           ShapeConfig("t", "train", SEQ, GLOBAL_BATCH), cl,
                           app_id="app", seed=3, probe_every=0,
                           total_steps=8, commit_every=3,
                           step_sim_s=STEP_SIM_S, device=CPU)
        steps = _record_commits(t)
        t.client.ckpt_interval_s = 0.5
        t.run(7)
        assert steps == [3, 6]
        assert cl.controller.clock.now() >= 7 * STEP_SIM_S
        t.finalize()


@pytest.mark.parametrize("trainer", [ElasticTrainer, JaxElasticTrainer])
def test_adaptive_interval_needs_a_moving_clock(trainer):
    """The reference's error, raised by both trainers alike."""
    cluster_cls = ICheckCluster if trainer is ElasticTrainer \
        else JaxICheckCluster
    port = trainer is ElasticTrainer
    cfg = (get_config if port else jax_get_config)(ARCH, tiny=True)
    shape = (ShapeConfig if port else JaxShapeConfig)("t", "train", SEQ,
                                                      GLOBAL_BATCH)
    extra = {"device": CPU} if port else {}
    with cluster_cls(n_icheck_nodes=1) as cl:
        with pytest.raises(ValueError, match="step_sim_s > 0"):
            trainer(cfg, shape, cl, adaptive_interval=True, step_sim_s=0.0,
                    **extra)


def test_replication_commits_two_copies():
    """The catalog finds two copies of every part of a commit (replicas 0
    and 1), placed on the agents as the reference trainer's are."""
    with ICheckCluster(n_icheck_nodes=2) as cl, \
            JaxICheckCluster(n_icheck_nodes=2) as jcl:
        jt, t = _pair(cl, jcl, replication=2, commit_every=2)
        got = {}
        for name, tr, c in (("ref", jt, jcl), ("port", t, cl)):
            assert tr.client.replication == 2
            tr.run(2)
            h = tr._pending_commits[-1]
            h.wait(timeout=60)
            meta = h.meta
            got[name] = {
                (k.region, k.part): sorted(
                    (key.replica, agent.agent_id)
                    for agent, key in c.controller.catalog.agents_with(
                        "app", meta.ckpt_id, k.region, k.part))
                for k in meta.shards}
            tr.finalize()
    assert got["port"] == got["ref"]
    assert got["port"]
    for where in got["port"].values():
        assert [r for r, _ in where] == [0, 1], where


def test_global_batch_sets_the_batch():
    with ICheckCluster(n_icheck_nodes=2) as cl, \
            JaxICheckCluster(n_icheck_nodes=2) as jcl:
        jt, t = _pair(cl, jcl, global_batch=2, commit_every=100)
        assert t.global_batch == jt.global_batch == 2
        shapes = []
        orig = t.data.next_batch

        def next_batch(*a, **kw):
            batch = orig(*a, **kw)
            shapes.append(batch["tokens"].shape)
            return batch
        t.data.next_batch = next_batch
        jt.run(3)
        t.run(3)
        assert shapes == [(2, SEQ)] * 3
        assert t.data.state.step == jt.data.state.step == 3
        np.testing.assert_allclose(_losses(t), _losses(jt), rtol=1e-5)
        for tr in (jt, t):
            tr.finalize()
    with ICheckCluster(n_icheck_nodes=1) as cl:
        t = ElasticTrainer(get_config(ARCH, tiny=True),
                           ShapeConfig("t", "train", SEQ, GLOBAL_BATCH), cl,
                           probe_every=0, commit_every=100, device=CPU)
        assert t.global_batch == GLOBAL_BATCH        # the shape's default
        t.finalize()
