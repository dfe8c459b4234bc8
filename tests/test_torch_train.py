"""The port's training path held against the JAX reference, on the CPU.

Same numpy inputs through both frameworks:

* rmsnorm's custom backward against ``jax.grad`` of the reference's;
* ``loss_fn`` value and grads on tiny qwen2.5, yi, rwkv6,
  recurrentgemma, seamless-m4t-medium (with its frames) and pixtral-12b
  (with its patches) (the MoE archs': test_torch_models.py), from the
  reference's parameters carried across by name:
  rtol 1e-5 (f32 sums in another order), each leaf also allowed atol 1e-6
  of its largest gradient (1e-5 for the recurrent models, whose
  recurrences' backwards sum in other orders, over many terms), with full
  remat and without.  recurrentgemma's ``lam`` is moved from its init
  (``_perturb``): there a = exp(-8 softplus(lam) r) is about 3e-8, the
  state forgets at once, and lam's gradient is a cancellation of roundoff
  (ROADMAP §3);
* AdamW twins of ``tests/test_optim.py``;
* two train steps from one state (``train_state_from_numpy``), also on
  tiny qwen3-moe-235b-a22b (its loss includes the aux loss): params and
  moments rtol 1e-5 (each leaf atol 1e-6 of its largest value, 1e-5 for
  the recurrent models), but for the elements the test names, held to the
  size of the steps taken;
* ``ElasticTrainer`` twins of ``tests/test_train_restart.py`` (port
  against port, raw codec: losses rtol 1e-6, params bit-equal) and
  ``tests/test_elastic.py`` (a 1 -> 2 resize, losses rtol 1e-5), and the
  q8-delta roundtrip with a resize of ``tests/test_delta_codec.py``, also
  on tiny rwkv6, recurrentgemma, seamless-m4t-medium and pixtral-12b.

f32 matmuls run in full precision (``allow_tf32 = False``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs files in parallel worker processes: few intra-op threads
# keep this file from crowding the others off the cores
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import loss_fn as jax_loss_fn  # noqa: E402
from repro.models.layers import rmsnorm as jax_rmsnorm  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import warmup_cosine as jax_warmup_cosine  # noqa: E402
from repro.train import make_train_state as jax_make_train_state  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.convert import (params_from_numpy,  # noqa: E402
                                 train_state_from_numpy)
from repro_torch.core import ICheckCluster  # noqa: E402
from repro_torch.models import loss_fn  # noqa: E402
from repro_torch.models.layers import rmsnorm  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init,  # noqa: E402
                               adamw_update, warmup_cosine)
from repro_torch.train import ElasticTrainer, make_train_step  # noqa: E402
from repro_torch.train.step import compute_grads  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False

ARCHS = ["qwen2.5-3b", "yi-6b", "rwkv6-7b", "recurrentgemma-9b",
         "qwen3-moe-235b-a22b", "seamless-m4t-medium", "pixtral-12b"]
# the MoE archs' loss and gradients are held in test_torch_models.py
# (both remat policies); here the MoE arch takes train steps
LOSS_ARCHS = [a for a in ARCHS if "moe" not in a]
# each leaf's atol, relative to its largest element
REL_ATOL = {"qwen2.5-3b": 1e-6, "yi-6b": 1e-6, "rwkv6-7b": 1e-5,
            "recurrentgemma-9b": 1e-5, "qwen3-moe-235b-a22b": 1e-6,
            # the encoder-decoder's: its gradients hold to 1e-6
            # (test_torch_encdec.py), but after two steps a few first
            # moments (AdamW's mu, 0.1 g a step, whose largest is some 20
            # times below g's) are 4e-6 of their largest apart
            "seamless-m4t-medium": 1e-5, "pixtral-12b": 1e-6}
CPU = torch.device("cpu")
# an overlap resize's background streams must land within this wall time
RESIZE_WAIT_S = 120
SHAPE = ShapeConfig("t", "train", 32, 4)


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def _batch(cfg, seed=0, b=2, t=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    labels = toks.copy()
    labels[:, -3:] = -1                      # masked targets count as none
    batch = {"tokens": toks, "labels": labels}
    # the encoder-decoder's audio frames, the VLM's vision patches
    if cfg.frontend == "frames":
        batch["frames"] = rng.standard_normal(
            (b, cfg.num_frames, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "patches":
        batch["patches"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return batch


def _perturb(tree, seed=1):
    """numpy params with every ``lam`` (the RG-LRU decay's logit) drawn
    from [-6, 0], where the decay and its gradient show (see the module's
    docstring); other leaves unchanged.  Trees without ``lam`` pass
    through."""
    tree = jax.tree.map(np.array, tree)
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, dict):
            if "lam" in t:
                t["lam"] = rng.uniform(-6.0, 0.0, t["lam"].shape) \
                    .astype(np.float32)
            for v in t.values():
                walk(v)
    walk(tree)
    return tree


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _assert_tree_close(got, want, rtol, rel_atol, skip=()):
    got, want = dict(_walk(got)), dict(_walk(want))
    assert got.keys() == want.keys()
    for name, w in want.items():
        w, g = _np(w), _np(got[name])
        for sel in skip:
            if sel[0] == name:
                w, g = np.delete(w, sel[1], axis=sel[2]), \
                    np.delete(g, sel[1], axis=sel[2])
        atol = rel_atol * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=name)


# ------------------------------------------------------------------ rmsnorm
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_grads_match_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    dy = rng.standard_normal((2, 5, 48)).astype(np.float32)

    def jf(xx, ss):
        y = jax_rmsnorm({"scale": ss}, xx)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(dy))

    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    jdx, jds = jax.grad(jf, argnums=(0, 1))(jx, jnp.asarray(scale))
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    ts = torch.from_numpy(scale).requires_grad_()
    y = rmsnorm({"scale": ts}, tx)
    (y.float() * torch.from_numpy(dy)).sum().backward()
    assert tx.grad.dtype == tx.dtype and ts.grad.dtype == torch.float32
    tol = {"float32": 1e-5, "bfloat16": 1e-2}[dtype]
    np.testing.assert_allclose(tx.grad.float().numpy(),
                               np.asarray(jdx.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jds), rtol=tol,
                               atol=tol)


# ------------------------------------------------------------------ loss_fn
@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_and_grads_match_jax(arch, remat):
    jcfg = dataclasses.replace(jax_get_config(arch, tiny=True),
                               remat_policy=remat)
    cfg = dataclasses.replace(get_config(arch, tiny=True), remat_policy=remat)
    jparams = _perturb(jax_init_params(jcfg, jax.random.key(1))[0])
    batch = _batch(cfg)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(jcfg, p, {k: jnp.asarray(v)
                                        for k, v in batch.items()},
                              impl="xla"), has_aux=True))(jparams)
    params = params_from_numpy(jparams, CPU)
    loss, metrics, grads = compute_grads(cfg, params, _port_batch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["xent"]), float(jm["xent"]),
                               rtol=1e-5)
    _assert_tree_close(grads, jax.tree.map(np.asarray, jgrads), rtol=1e-5,
                       rel_atol=REL_ATOL[arch])


def test_loss_fn_grads_through_autograd_equal_bound_leaves():
    """The train step's per-layer leaves give the gradient plain autograd
    gives on the stacked tree."""
    cfg = get_config("qwen2.5-3b", tiny=True)
    from repro_torch.models import init_params
    params = init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    batch = _port_batch(_batch(cfg, seed=2))
    _, _, grads = compute_grads(cfg, params, batch)
    leaves = {n: t.detach().clone().requires_grad_()
              for n, t in _walk(params)}

    def tree(path_tree, prefix=()):
        if isinstance(path_tree, dict):
            return {k: tree(v, prefix + (k,)) for k, v in path_tree.items()}
        return leaves["/".join(prefix)]

    loss, _ = loss_fn(cfg, tree(params), batch)
    loss.backward()
    for name, g in _walk(grads):
        assert torch.equal(g, leaves[name].grad), name


# ------------------------------------------------------------------- AdamW
def test_adamw_converges_quadratic():
    target = torch.linspace(-2, 2, 64)
    params = {"w": torch.zeros(64)}
    cfg = AdamWConfig(lr=0.05, weight_decay=0.0)
    state = adamw_init(params)
    for _ in range(300):
        grads = {"w": params["w"] - target}
        params, state, _ = adamw_update(grads, state, params, cfg)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=1e-2)


def test_grad_clip():
    params = {"w": torch.zeros(4)}
    state = adamw_init(params)
    _, _, m = adamw_update({"w": torch.full((4,), 100.0)}, state, params,
                           AdamWConfig(grad_clip=1.0))
    assert float(m["grad_norm"]) > 100


def test_warmup_cosine_shape():
    s = warmup_cosine(1.0, warmup=10, total=100)
    js = jax_warmup_cosine(1.0, warmup=10, total=100)
    for step in (0, 5, 10, 50, 100, 120):
        np.testing.assert_allclose(float(s(torch.tensor(step))),
                                   float(js(step)), rtol=1e-6, atol=1e-7)
    assert float(s(torch.tensor(0))) == 0.0
    assert abs(float(s(torch.tensor(100))) - 0.1) < 1e-2


def test_compressed_grads_converge_with_error_feedback():
    target = torch.linspace(-1, 1, 256)
    cfg = AdamWConfig(lr=0.05, weight_decay=0.0, compress_grads=True)
    params = {"w": torch.zeros(256)}
    state = adamw_init(params, compress=True)
    assert state.err is not None
    for _ in range(400):
        grads = {"w": params["w"] - target}
        params, state, _ = adamw_update(grads, state, params, cfg)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=5e-2)


def test_count_increments():
    params = {"w": torch.zeros(4)}
    state = adamw_init(params)
    _, state, _ = adamw_update({"w": torch.ones(4)}, state, params,
                               AdamWConfig())
    assert int(state.count) == 1 and state.count.dtype == torch.int32


# --------------------------------------------------------------- train step
@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, compress):
    """Two steps from one state.  Two kinds of element are held apart,
    each to the size of the steps taken (the sum of the learning rates):

    * the key bias, whose exact gradient is zero (softmax does not see a
      shift of every key), so both frameworks update it by roundoff, and
      AdamW's g / (|g| + eps) makes that roundoff a step of size lr;
    * with ``compress_grads``, at most 1e-3 of each leaf's elements: the
      reference's XLA codec may round a code one step away
      (``tests/test_kernels_codec.py``'s tolerance), which moves that
      gradient element by one quantization step;
    * in the recurrent models, with or without compression, at most one
      element a leaf or 1e-3 of its elements: AdamW divides each gradient
      element by its own size (m / sqrt(v)), so an element whose gradient
      lies near the roundoff of the recurrences' backwards (summed in
      other orders, ``REL_ATOL``) takes a step whose size that roundoff
      sets.  The same holds for the MoE model (its family is not
      ``dense`` either): an expert that few tokens reach has weight
      gradients near that roundoff (one ``w_gu`` element of 98,304, 1e-5
      apart after two steps of 1e-3 and 5e-4).  The encoder-decoder
      and the VLM (families ``audio`` and ``vlm``) are held so too.
    """
    jcfg = jax_get_config(arch, tiny=True)
    cfg = get_config(arch, tiny=True)
    recurrent = cfg.family != "dense"
    jopt = JaxAdamWConfig(lr=1e-3, compress_grads=compress)
    opt = AdamWConfig(lr=1e-3, compress_grads=compress)
    jstate = jax_make_train_state(jcfg, jax.random.key(2), jopt)
    jstate = jstate._replace(params=jax.tree.map(
        jnp.asarray, _perturb(jstate.params)))
    state = train_state_from_numpy(jax.tree.map(np.asarray, jstate), CPU)
    batch = _batch(cfg, seed=3, b=4)
    jstep = jax.jit(jax_make_train_step(
        jcfg, jopt, jax_warmup_cosine(1e-3, 2, 10), impl="xla"))
    step = make_train_step(cfg, opt, warmup_cosine(1e-3, 2, 10))
    for i in range(2):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, _port_batch(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    assert int(state.step) == int(jstate.step) == 2
    assert int(state.opt.count) == 2
    steps_lr = 5e-4 + 1e-3
    kbias = [("stack/b0/attn/bkv", 0, 1)] if cfg.qkv_bias else []
    for got, want in ((state.params, jstate.params),
                      (state.opt.mu, jstate.opt.mu),
                      (state.opt.nu, jstate.opt.nu)):
        got = dict(_walk(got))
        want = dict(_walk(jax.tree.map(np.asarray, want)))
        if kbias:
            np.testing.assert_allclose(
                _np(got["stack/b0/attn/bkv"])[:, 0],
                want["stack/b0/attn/bkv"][:, 0], atol=steps_lr)
        if not (compress or recurrent):
            _assert_tree_close(got, want, rtol=1e-5,
                               rel_atol=REL_ATOL[arch], skip=kbias)
            continue
        for name, w in want.items():
            g = _np(got[name])
            far = ~np.isclose(g, w, rtol=1e-5,
                              atol=REL_ATOL[arch]
                              * max(np.abs(w).max(), 1e-30))
            allowed = 1e-3 * far.size
            if recurrent:
                allowed = max(allowed, 1)
            assert far.sum() <= allowed or name == "stack/b0/attn/bkv", name
            np.testing.assert_allclose(g, w, atol=steps_lr, err_msg=name)


def test_microbatches_average_the_gradient():
    cfg = get_config("qwen2.5-3b", tiny=True)
    from repro_torch.train import make_train_state
    batch = _port_batch(_batch(cfg, seed=4, b=4))
    outs = []
    for mb in (1, 2):
        state = make_train_state(cfg, torch.Generator().manual_seed(0),
                                 AdamWConfig(lr=1e-3), device=CPU)
        state, m = make_train_step(cfg, AdamWConfig(lr=1e-3),
                                   microbatches=mb)(state, batch)
        outs.append((float(m["loss"]), dict(_walk(state.params))))
    # the tokens' losses are averaged per microbatch, and each microbatch
    # holds the same number of unmasked targets here
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-5)
    for name, p in outs[0][1].items():
        np.testing.assert_allclose(outs[1][1][name].numpy(), p.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


# ------------------------------------------------------------ ElasticTrainer
def _trainer(cluster, app_id, seed, **kw):
    kw.setdefault("commit_every", 100)
    return ElasticTrainer(get_config(kw.pop("arch", "qwen2.5-3b"),
                                     tiny=True), SHAPE, cluster,
                          app_id=app_id, seed=seed,
                          opt_cfg=AdamWConfig(lr=1e-3), probe_every=0,
                          device=CPU, **kw)


def test_restart_equivalence():
    with ICheckCluster(n_icheck_nodes=2) as cluster:
        ref = _trainer(cluster, "ref", 3, total_steps=12)
        ref.run(12)
        ref_losses = [m["loss"] for m in ref.metrics_log]
        ref_params = dict(_walk(ref.state.params))
        ref.finalize()

    with ICheckCluster(n_icheck_nodes=2) as cluster:
        t1 = _trainer(cluster, "app", 3, total_steps=12)
        assert not t1.restarted
        t1.run(6)
        first = [m["loss"] for m in t1.metrics_log]
        t1.commit(blocking=True)
        t2 = _trainer(cluster, "app", 3, total_steps=12)
        assert t2.restarted
        assert int(t2.state.step) == 6 and t2.data.state.step == 6
        t2.run(6)
        resumed = [m["loss"] for m in t2.metrics_log]
        t2.finalize()

    np.testing.assert_allclose(first + resumed, ref_losses, rtol=1e-6)
    for name, p in _walk(t2.state.params):
        assert torch.equal(p, ref_params[name]), name


def test_dropped_trainer_releases_its_state():
    """A trainer lost without ``finalize`` (a crash) is freed with its
    state: the event bus holds it weakly, and its subscription goes too."""
    import gc
    import weakref

    with ICheckCluster(n_icheck_nodes=2) as cluster:
        t = _trainer(cluster, "app", 1, total_steps=4)
        t.run(2)
        t.commit(blocking=True)
        subs = len(cluster.controller.bus._subs)
        ref = weakref.ref(t)
        del t
        gc.collect()
        assert ref() is None
        assert len(cluster.controller.bus._subs) == subs - 1
        t2 = _trainer(cluster, "app", 1, total_steps=4)
        assert t2.restarted and int(t2.state.step) == 2
        t2.finalize()


def test_restart_from_l2_after_l1_loss():
    with ICheckCluster(n_icheck_nodes=2, keep_l1=1) as cluster:
        t1 = _trainer(cluster, "app", 1, total_steps=10)
        t1.run(4)
        t1.commit(blocking=True)
        cluster.controller.wait_for_drains(timeout=30)
        for mgr in cluster.controller.managers():
            for agent in list(mgr.agents()):
                cluster.fault.kill_agent(agent.agent_id)
        t2 = _trainer(cluster, "app", 1, total_steps=10)
        assert t2.restarted and int(t2.state.step) == 4
        t2.run(2)
        assert np.isfinite(t2.metrics_log[-1]["loss"])


@pytest.mark.parametrize("overlap", [False, True])
def test_resize_preserves_trajectory(overlap):
    """Expand 1 -> 2 logical ranks mid-run: the loss trajectory matches an
    uninterrupted run.  With ``overlap_resize`` the resize completes at the
    first step after its background streams have landed, so the test
    waits for them (not for a number of steps, which a loaded host may
    not finish them in) before the last 5 steps."""
    with ICheckCluster(n_icheck_nodes=2) as cluster:
        ref = _trainer(cluster, "ref", 5, arch="yi-6b", total_steps=12)
        ref.run(12)
        ref_losses = [m["loss"] for m in ref.metrics_log]
        ref.finalize()
    with ICheckCluster(n_icheck_nodes=2) as cluster:
        t = _trainer(cluster, "app", 5, arch="yi-6b", total_steps=12,
                     overlap_resize=overlap)
        t.run(6)
        cluster.rm.schedule_resize("app", 2)
        t.run(1)       # opens the overlap window (or resizes at once)
        assert t.wait_resize_streams(timeout=RESIZE_WAIT_S)
        t.run(5)
        assert t.resizes == 1 and t.app.ranks == 2
        if overlap:
            assert t.steps_during_resize >= 1
        losses = [m["loss"] for m in t.metrics_log]
        t.finalize()
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)


def test_elastic_trainer_q8_delta_roundtrip():
    _q8_delta_roundtrip("yi-6b")


@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-9b"])
def test_elastic_trainer_q8_delta_roundtrip_recurrent(arch):
    """The round trip above on the recurrent models, whose training runs
    the ops' backwards (the plain ones on the CPU)."""
    _q8_delta_roundtrip(arch)


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "pixtral-12b"])
def test_elastic_trainer_q8_delta_roundtrip_frontends(arch):
    """The round trip above on the encoder-decoder and the VLM: the
    trainer's batches carry frames / patches, the q8-delta commits carry
    the encoder's and the frontend's leaves."""
    _q8_delta_roundtrip(arch)


def _q8_delta_roundtrip(arch):
    with ICheckCluster(n_icheck_nodes=2) as cluster:
        t = _trainer(cluster, "app", 5, arch=arch, commit_every=2,
                     total_steps=12, codec="q8-delta")
        t.run(4)
        cluster.rm.schedule_resize("app", 2)
        t.run(4)
        assert t.resizes == 1
        tel = cluster.telemetry.snapshot()["per_app"]["app"]
        assert tel["delta_key_frames"] > 0
        assert tel["codec_compression_ratio"] > 3.0
        assert np.isfinite(t.metrics_log[-1]["loss"])
        t.finalize()



@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "pixtral-12b"])
def test_train_cli_frontends_on_cpu(arch, capsys):
    """Tiny seamless-m4t-medium and pixtral-12b through the trainer's CLI,
    two microbatches a step (the frames / patches split with the
    tokens), then through the ElasticTrainer with a resize."""
    from repro_torch.launch.train import main

    main(["--arch", arch, "--device", "cpu", "--steps", "3",
          "--global-batch", "4", "--seq-len", "16", "--microbatches", "2"])
    main(["--arch", arch, "--icheck", "--device", "cpu", "--steps", "6",
          "--commit-every", "2", "--resize-at", "3", "--global-batch", "4",
          "--seq-len", "16"])
    out = capsys.readouterr().out
    assert "3 steps in" in out
    assert "[resize] 1 -> 2 ranks, resizes=1" in out
    assert np.isfinite(float(out.split("final loss ")[1].split()[0]))


def test_train_cli_moe_on_cpu(capsys):
    """Tiny qwen3-moe-235b-a22b through the trainer's CLI: 12 steps,
    commits every 4 and a 1 -> 2 resize at step 6."""
    from repro_torch.launch.train import main

    main(["--arch", "qwen3-moe-235b-a22b", "--icheck", "--device", "cpu",
          "--steps", "12", "--commit-every", "4", "--resize-at", "6"])
    out = capsys.readouterr().out
    assert "[resize] 1 -> 2 ranks, resizes=1" in out
    final = float(out.split("final loss ")[1].split()[0])
    assert np.isfinite(final)
