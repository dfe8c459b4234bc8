"""The port's "model" axis (tensor parallelism, ``sharding/tp.py``) held
against the JAX reference on tiny yi-6b (GQA 4 / 2), qwen2.5-3b (QKV
bias, a 200-word vocab padded to 256, so only the last vocab shard masks,
and full remat: every layer with its collectives recomputed in the
backward) and deepseek-7b (MHA), in gloo worlds of 2 ranks ("model" 2)
and 4 ranks ("data" 2 x "model" 2), ``torch_dp_workers.py``:

* each rank's param shards are its boxes of the reference's
  ``param_specs`` under ``TP_RULES`` (exact);
* prefill logits and the KV cache, assembled from every rank's box: rtol
  1e-5, atol 1e-6 of the leaf's largest value (the padded vocab's logits
  exactly -1e30); the greedy tokens equal the reference engine's;
* the cache committed through iCheck as one part a rank (2 and 4),
  restored on the mesh bit-equal to a second prefill, and restored whole
  on one rank bit-equal to the ranks' boxes; decode from either gives the
  live run's tokens;
* the loss (rtol 1e-5) and every gradient leaf (rtol 1e-5, atol 1e-6 of
  its largest value, ``test_torch_train_dp.py``'s), and two train steps'
  losses and clip norms (the split leaves' squares summed over the model
  ranks) against the reference's jitted train step (rtol 1e-5);
* a "model" axis that does not divide raises ``ValueError``: tiny
  phi3-medium-14b's 5 heads at 2, yi-6b's 4 kv heads at 8, an arch whose
  split is a later slice.

Then the reference's own run under a ("data", "model") mesh of 4 forced
host devices (a subprocess): its prefill logits and loss equal its
one-device run's, which the port's are held to above.
"""
import dataclasses
import pickle
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import init_cache as jax_init_cache  # noqa: E402
from repro.models import loss_fn as jax_loss_fn  # noqa: E402
from repro.models import param_specs as jax_param_specs  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import warmup_cosine as jax_warmup_cosine  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.sharding import TP_RULES as JAX_TP_RULES  # noqa: E402
from repro.train import make_train_state as jax_make_train_state  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.serve import serve_max_len  # noqa: E402
from repro_torch.sharding import NamedSharding  # noqa: E402
from repro_torch.sharding.tp import check_model_axis  # noqa: E402

import torch_dp_workers as workers  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CASES = [("yi-6b", {}),
         ("qwen2.5-3b", {"vocab_size": 200, "remat_policy": "full"}),
         ("deepseek-7b", {})]
B, T, GEN, STEPS = 4, 12, 5, 2
WORLDS = {"model2": (1, 2), "data2_model2": (2, 2)}


def _names(tree, path=()):
    """("/"-joined path, leaf) of a dict / NamedTuple tree, sorted keys."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _names(tree[k], path + (k,))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            if v is not None:
                yield from _names(v, path + (f,))
    else:
        yield "/".join(path), tree


def _cfgs(arch, over):
    return (dataclasses.replace(jax_get_config(arch, tiny=True), **over),
            dataclasses.replace(get_config(arch, tiny=True), **over))


def _reference(arch, over):
    jcfg, _ = _cfgs(arch, over)
    jopt = JaxAdamWConfig(lr=1e-3)
    jstate = jax_make_train_state(jcfg, jax.random.key(0), jopt)
    params = jstate.params
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    labels = toks.copy()
    labels[: B // 2, T // 2:] = -1        # the first data rank's half
    batch = {"tokens": toks, "labels": labels}
    max_len = serve_max_len(jcfg, T, GEN)
    logits, cache = jax_prefill(jcfg, params, {"tokens": jnp.asarray(toks)},
                                jax_init_cache(jcfg, B, max_len))
    tokens = JaxServeEngine(jcfg, params, max_len=max_len).generate(
        {"tokens": toks}, gen_len=GEN)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), grads = jax.value_and_grad(
        lambda p: jax_loss_fn(jcfg, p, jbatch, impl="xla"),
        has_aux=True)(params)
    step = jax.jit(jax_make_train_step(jcfg, jopt,
                                       jax_warmup_cosine(1e-3, 2, 10),
                                       impl="xla"))
    losses, norms = [], []
    for _ in range(STEPS):
        jstate, m = step(jstate, jbatch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"params": jax.tree.map(np.asarray, params), "batch": batch,
            "logits": np.asarray(logits),
            "cache": {n: np.asarray(v) for n, v in _names(cache)},
            "tokens": np.asarray(tokens), "loss": float(loss),
            "grads": {n: np.asarray(g) for n, g in _names(grads)},
            "losses": losses, "grad_norms": norms}


@pytest.fixture(scope="module")
def reference():
    return {arch: _reference(arch, over) for arch, over in CASES}


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()


@pytest.fixture(scope="module", params=sorted(WORLDS))
def world(request, reference, tmp_path_factory):
    from repro_torch.models import init_params

    phi3 = init_params(get_config("phi3-medium-14b", tiny=True),
                       torch.Generator().manual_seed(0), "cpu")
    cases = [{"arch": arch, "over": over,
              "params": reference[arch]["params"],
              "tokens": reference[arch]["batch"]["tokens"], "gen": GEN,
              "batch": reference[arch]["batch"]}
             for arch, over in CASES]
    cases[0]["phi3_params"] = _numpy(phi3)
    data, model = WORLDS[request.param]
    out = workers.spawn_world(workers.tp_world, data * model,
                              tmp_path_factory.mktemp(request.param), data,
                              model, cases, STEPS)
    return data, model, out


def _mesh(data, model):
    """A stand-in ("data", "model") mesh: what ``NamedSharding`` reads."""
    return types.SimpleNamespace(
        mesh_dim_names=("data", "model"),
        mesh=torch.arange(data * model).reshape(data, model))


def _reference_boxes(arch, over, shapes, data, model):
    """leaf name -> rank -> box of the reference's ``param_specs`` under
    ``TP_RULES`` on a (data, model) mesh, for params of ``shapes``."""
    jcfg, _ = _cfgs(arch, over)
    axes = jax_init_params(jcfg, jax.random.key(0))[1]
    specs = jax_param_specs(axes, JAX_TP_RULES,
                            types.SimpleNamespace(shape={"data": data,
                                                         "model": model}),
                            shapes)
    flat_specs = dict(_names(specs))
    out = {}
    for name, shape in _names(shapes):
        out[name] = NamedSharding(_mesh(data, model), tuple(
            flat_specs[name])).devices_indices_map(shape.shape)
    return out


def _rank(coord, model):
    return coord[0] * model + coord[1]


def _close(got, want, name, rtol=1e-5):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-6 * max(np.abs(want).max(), 1e-30),
                               err_msg=name)


@pytest.mark.parametrize("arch", [a for a, _ in CASES])
def test_param_shards_are_the_reference_boxes(world, reference, arch):
    data, model, out = world
    over = dict(CASES)[arch]
    i = [a for a, _ in CASES].index(arch)
    boxes = _reference_boxes(arch, over, reference[arch]["params"], data,
                             model)
    full = dict(_names(reference[arch]["params"]))
    for res in out["train"]:
        r = _rank(res[i]["coord"], model)
        assert sorted(res[i]["params"]) == sorted(full)
        for name, part in res[i]["params"].items():
            np.testing.assert_array_equal(part, full[name][boxes[name][r]],
                                          err_msg=name)
    # the heads, KV heads, d_ff and vocab are split in model parts
    shapes = out["serve"]["cases"][0][i]["param_shapes"]
    assert shapes["stack/b0/attn/wq"][-1] == full["stack/b0/attn/wq"].shape[
        -1] // model
    assert shapes["embed/table"][0] == full["embed/table"].shape[0] // model


def _assembled(parts, data, model, dims):
    """A whole array from every rank's box of it (mesh coordinate ->
    part): ``dims`` are the (batch, model-split) dims of a part."""
    first = next(iter(parts.values()))
    shape = list(first.shape)
    shape[dims[0]] *= data
    shape[dims[1]] *= model
    full = np.empty(shape, first.dtype)
    for (d, m), part in parts.items():
        idx = [slice(None)] * len(shape)
        nb, nm = part.shape[dims[0]], part.shape[dims[1]]
        idx[dims[0]] = slice(d * nb, (d + 1) * nb)
        idx[dims[1]] = slice(m * nm, (m + 1) * nm)
        full[tuple(idx)] = part
    return full


@pytest.mark.parametrize("arch", [a for a, _ in CASES])
def test_prefill_logits_and_cache_match_reference(world, reference, arch):
    data, model, out = world
    ref = reference[arch]
    i = [a for a, _ in CASES].index(arch)
    ranks = out["serve"]["cases"]
    logits = _assembled({r[i]["coord"]: r[i]["logits"] for r in ranks},
                        data, model, (0, 1))
    vocab = _cfgs(arch, dict(CASES)[arch])[1].vocab_size
    _close(logits[:, :vocab], ref["logits"][:, :vocab], "logits")
    np.testing.assert_array_equal(logits[:, vocab:], ref["logits"][:, vocab:])
    assert (logits[:, vocab:] == np.float32(-1e30)).all()
    for name in ("stack/b0/self/k", "stack/b0/self/v"):
        whole = _assembled({r[i]["coord"]: r[i]["cache"][name]
                            for r in ranks}, data, model, (1, 2))
        _close(whole, ref["cache"][name], name)
        # the whole cache restored on one rank is the ranks' boxes
        np.testing.assert_array_equal(ranks[0][i]["whole"][name], whole)


@pytest.mark.parametrize("arch", [a for a, _ in CASES])
def test_greedy_tokens_and_restored_decode(world, reference, arch):
    data, model, out = world
    i = [a for a, _ in CASES].index(arch)
    ranks = out["serve"]["cases"]
    want = reference[arch]["tokens"]
    for r in ranks:
        np.testing.assert_array_equal(r[i]["tokens"], want)
        assert r[i]["restored_equal"]
        np.testing.assert_array_equal(r[i]["restored_decode"], want[:, 1:])
    np.testing.assert_array_equal(ranks[0][i]["whole_decode"], want[:, 1:])
    # one part a rank for the K/V leaves, the index whole
    assert ranks[0][i]["parts"] == {"idx": 1,
                                    "stack/b0/self/k": data * model,
                                    "stack/b0/self/v": data * model}


@pytest.mark.parametrize("arch", [a for a, _ in CASES])
def test_loss_grads_and_steps_match_reference(world, reference, arch):
    data, model, out = world
    ref = reference[arch]
    i = [a for a, _ in CASES].index(arch)
    boxes = _reference_boxes(arch, dict(CASES)[arch], ref["params"], data,
                             model)
    for res in out["train"]:
        r = _rank(res[i]["coord"], model)
        np.testing.assert_allclose(res[i]["loss"], ref["loss"], rtol=1e-5)
        assert sorted(res[i]["grads"]) == sorted(ref["grads"])
        for name, g in res[i]["grads"].items():
            want = ref["grads"][name]
            _close(g, want[boxes[name][r]], name)
        np.testing.assert_allclose(res[i]["losses"], ref["losses"],
                                   rtol=1e-5)
        np.testing.assert_allclose(res[i]["grad_norms"], ref["grad_norms"],
                                   rtol=1e-5)


def test_model_axis_that_does_not_divide_raises(world):
    _, _, out = world
    assert "does not divide its 5 heads" in out["serve"]["phi3_raised"]


@pytest.mark.parametrize("arch, size, what", [
    ("yi-6b", 8, "4 kv heads"), ("phi3-medium-14b", 3, "40 heads"),
    ("qwen2.5-3b", 16, "2 kv heads")])
def test_check_model_axis_names_the_axis(arch, size, what):
    with pytest.raises(ValueError, match=what):
        check_model_axis(get_config(arch), size)
    check_model_axis(get_config(arch), 2)


@pytest.mark.parametrize("arch", ["dbrx-132b", "rwkv6-7b",
                                  "recurrentgemma-9b", "seamless-m4t-medium",
                                  "pixtral-12b"])
def test_later_slices_raise(arch):
    with pytest.raises(ValueError, match="not split"):
        check_model_axis(get_config(arch), 2)
    cfg = dataclasses.replace(get_config("yi-6b"), kv_quant=True)
    with pytest.raises(ValueError, match="int8"):
        check_model_axis(cfg, 2)


REFERENCE_MESH = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
sys.path.insert(0, "src")
from repro.configs import get_config
from repro.models import init_cache, init_params, loss_fn, param_specs, prefill
from repro.sharding import TP_RULES, use_rules

out = sys.argv[1]
with open(out, "rb") as f:
    cases = pickle.load(f)
mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
res = {}
for arch, over, params, batch, max_len in cases:
    cfg = dataclasses.replace(get_config(arch, tiny=True), **over)
    specs = param_specs(init_params(cfg, jax.random.key(0))[1], TP_RULES,
                        mesh, params)
    sharded = jax.tree.map(lambda a, s: jax.device_put(
        a, NamedSharding(mesh, s)), params, specs)
    toks = jnp.asarray(batch["tokens"])

    @jax.jit
    def run(p, b):
        with use_rules(mesh, TP_RULES):
            logits, _ = prefill(cfg, p, {"tokens": b["tokens"]},
                                init_cache(cfg, b["tokens"].shape[0],
                                           max_len))
            loss, _ = loss_fn(cfg, p, b, impl="xla")
        return logits, loss
    logits, loss = run(sharded, {k: jnp.asarray(v) for k, v in batch.items()})
    res[arch] = {"logits": np.asarray(logits), "loss": float(loss),
                 "wq_shard": sharded["stack"]["b0"]["attn"]["wq"]
                 .addressable_shards[0].data.shape}
with open(out, "wb") as f:
    pickle.dump(res, f)
print("REFERENCE_MESH_OK")
"""


def test_reference_under_a_mesh_matches_its_one_device_run(reference,
                                                           tmp_path):
    """The reference partitioned by GSPMD under ``TP_RULES`` on a (2, 2)
    mesh gives the logits and loss of its one-device run, which the
    port's split run is held to above: the split changes no answer."""
    out = tmp_path / "mesh.pkl"
    cases = [(arch, over, reference[arch]["params"],
              reference[arch]["batch"], serve_max_len(
                  _cfgs(arch, over)[1], T, GEN)) for arch, over in CASES]
    with open(out, "wb") as f:
        pickle.dump(cases, f)
    proc = subprocess.run([sys.executable, "-c", REFERENCE_MESH, str(out)],
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=300)
    assert "REFERENCE_MESH_OK" in proc.stdout, proc.stdout + proc.stderr
    with open(out, "rb") as f:
        got = pickle.load(f)
    for arch, over in CASES:
        ref = reference[arch]
        vocab = _cfgs(arch, over)[1].vocab_size
        wq = ref["params"]["stack"]["b0"]["attn"]["wq"].shape
        assert got[arch]["wq_shard"] == (*wq[:-1], wq[-1] // 2)
        _close(got[arch]["logits"][:, :vocab], ref["logits"][:, :vocab],
               f"{arch} logits")
        np.testing.assert_allclose(got[arch]["loss"], ref["loss"], rtol=1e-5)
