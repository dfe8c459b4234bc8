"""The port's "model" axis (tensor and expert parallelism,
``sharding/tp.py``) and, under ``FSDP_RULES``, its parameters' "data"
axis, held against the JAX reference in gloo worlds of 2 ranks ("model"
2), 4 ranks ("data" 2 x "model" 2), 4 ranks ("model" 4) and 2 ranks
("data" 2, FSDP alone), ``torch_dp_workers.py``:

* tiny yi-6b (GQA 4 / 2), qwen2.5-3b (QKV bias, a 200-word vocab padded
  to 256, so only the last vocab shard masks, and full remat: every layer
  with its collectives recomputed in the backward) and deepseek-7b (MHA)
  in every world; at "model" 4 yi-6b's and qwen2.5-3b's kv heads split
  inside a head (``wkv``'s 32 columns, 8 a rank), so K/V are gathered and
  the cache is whole on every model rank;
* tiny phi3-medium-14b at "model" 2: 5 heads, so ``wq``'s box ends inside
  a head, q and K/V are gathered, the attention runs whole on every rank
  and ``o`` is sliced to ``wo``'s row box;
* tiny rwkv6-7b (full remat) and recurrentgemma-9b (one kv head, so its
  ``wkv`` splits inside it at every size; a 20-token prompt over its
  window of 16 rolls the ring) in every world but the first's dense
  ones: the "rnn" axis, RWKV-6's ``u`` / ``gn_scale`` / ``gn_bias`` over
  head_dim, the RG-LRU's ``w_ai`` over its contraction rows;
* tiny dbrx-132b (4 experts, top 2) and qwen3-moe (8 experts, top 2,
  full remat: each layer's gathers recomputed in the backward) under
  ``FSDP_RULES``, as their full configs name them, in every world: the
  experts split over "model" (one a rank for dbrx at "model" 4), every
  leaf's embed rows over "data" (gathered a layer at a time, their
  gradients reduce-scattered);

and for each:

* each rank's param shards are its boxes of the reference's
  ``param_specs`` under the case's rules (exact);
* prefill logits and every cache / state leaf, each rank's its box of the
  reference's ``cache_axes`` under the rules: rtol 1e-5, atol 1e-6 of the
  leaf's largest value (the padded vocab's logits exactly -1e30); the
  greedy tokens equal the reference engine's;
* the cache committed through iCheck as one part a distinct box,
  restored on the mesh bit-equal to a second prefill, and restored whole
  on one rank bit-equal to the ranks' boxes; decode from either gives the
  live run's tokens;
* the loss (rtol 1e-5) and every gradient leaf (rtol 1e-5, atol 1e-6 of
  its largest value, ``test_torch_train_dp.py``'s; 1e-4 for the
  recurrent models, ``GRAD_ATOL``), and two train
  steps' losses and clip norms (each leaf's squares summed over the axes
  that split it) against the reference's jitted train step (rtol 1e-5;
  the recurrent models' norms 1e-4, ``NORM_RTOL``);
* what still raises ``ValueError``: an RWKV-6 split inside its heads
  (tiny rwkv6 with one head of 64 on each "model" world's mesh), the
  encoder-decoder and frontends, the int8 cache, ``SEQ_RULES``; and the
  resolved layout where a size does not divide the heads (yi-6b at 8,
  phi3-medium-14b at 3, qwen2.5-3b at 16) or the experts (dbrx-132b's
  16 at 3 stay whole; qwen3-moe's 128 at 8 give 16 a rank).

Then the reference's own run under ("data", "model") meshes of (2, 2),
(1, 4) and, for the MoE models under ``FSDP_RULES``, (2, 1) forced host
devices (a subprocess): its prefill logits and loss equal its one-device
run's, which the port's are held to above.
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
from repro.models import cache_axes as jax_cache_axes  # noqa: E402
from repro.models import init_cache as jax_init_cache  # noqa: E402
from repro.models import loss_fn as jax_loss_fn  # noqa: E402
from repro.models import param_specs as jax_param_specs  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models import abstract_params as jax_abstract_params  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import warmup_cosine as jax_warmup_cosine  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.sharding import get_rules as jax_get_rules  # noqa: E402
from repro.sharding import spec as jax_spec  # noqa: E402
from repro.train import make_train_state as jax_make_train_state  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import init_cache  # noqa: E402
from repro_torch.serve import serve_max_len  # noqa: E402
from repro_torch.sharding import FSDP_RULES, SEQ_RULES  # noqa: E402
from repro_torch.sharding import TP_RULES, NamedSharding  # noqa: E402
from repro_torch.sharding.tp import check_model_axis, local_shape  # noqa: E402

import torch_dp_workers as workers  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# arch -> (config overrides, prompt tokens)
CASES = {"yi-6b": ({}, 12),
         "qwen2.5-3b": ({"vocab_size": 200, "remat_policy": "full"}, 12),
         "deepseek-7b": ({}, 12),
         "phi3-medium-14b": ({}, 12),
         "rwkv6-7b": ({"remat_policy": "full"}, 12),
         # a prompt longer than the window of 16 rolls the ring
         "recurrentgemma-9b": ({}, 20),
         # the MoE models under the rules their full configs name (the
         # tiny ones name "tp")
         "dbrx-132b": ({"rules": "fsdp"}, 12),
         "qwen3-moe-235b-a22b": ({"rules": "fsdp", "remat_policy": "full"},
                                 12)}
B, GEN, STEPS = 4, 5, 2
RECURRENT = ["rwkv6-7b", "recurrentgemma-9b"]
MOE = ["dbrx-132b", "qwen3-moe-235b-a22b"]
# each gradient leaf's atol, relative to its largest element: on this
# batch the recurrent models' one-process gradients lie up to 2.6e-5 of
# it from the reference's (rwkv6-7b's wA; f32 sums through the
# recurrence in other orders), the split ones as far
GRAD_ATOL = {arch: 1e-4 if arch in RECURRENT else 1e-6 for arch in CASES}
# the clip norms' rtol: rwkv6-7b's one-process norms lie 4.7e-5 from the
# reference's at the second step (its gradients 2.6e-5 of their largest)
NORM_RTOL = {arch: 1e-4 if arch in RECURRENT else 1e-5 for arch in CASES}
# world -> ((data, model), its archs)
WORLDS = {"model2": ((1, 2), ["yi-6b", "qwen2.5-3b", "deepseek-7b",
                              "phi3-medium-14b"] + RECURRENT + MOE),
          "data2_model2": ((2, 2), ["yi-6b", "qwen2.5-3b", "deepseek-7b"]
                           + RECURRENT + MOE),
          "model4": ((1, 4), ["yi-6b", "qwen2.5-3b"] + RECURRENT + MOE),
          # FSDP alone: the MoE models' params split over "data" only
          "data2": ((2, 1), MOE)}
CELLS = [(w, a) for w in sorted(WORLDS) for a in WORLDS[w][1]]
CELL_IDS = [f"{w}-{a}" for w, a in CELLS]


def _names(tree, path=()):
    """("/"-joined path, leaf) of a dict / NamedTuple / list tree, sorted
    keys (the snapshot bridge's names)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _names(tree[k], path + (k,))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            if v is not None:
                yield from _names(v, path + (f,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _names(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def _is_axes(x):
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, str) for e in x)


def _axes_names(tree, path=()):
    """("/"-joined path, axes) of an axes tree, in ``_names``' order."""
    if _is_axes(tree):
        yield "/".join(path), tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _axes_names(tree[k], path + (k,))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            if v is not None:
                yield from _axes_names(v, path + (f,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _axes_names(v, path + (str(i),))


def _cfgs(arch):
    over = CASES[arch][0]
    return (dataclasses.replace(jax_get_config(arch, tiny=True), **over),
            dataclasses.replace(get_config(arch, tiny=True), **over))


def _reference(arch):
    jcfg, _ = _cfgs(arch)
    t = CASES[arch][1]
    jopt = JaxAdamWConfig(lr=1e-3)
    jstate = jax_make_train_state(jcfg, jax.random.key(0), jopt)
    params = jstate.params
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (B, t)).astype(np.int32)
    labels = toks.copy()
    labels[: B // 2, t // 2:] = -1        # the first data rank's half
    batch = {"tokens": toks, "labels": labels}
    max_len = serve_max_len(jcfg, t, GEN)
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
            "cache_axes": dict(_axes_names(jax_cache_axes(jcfg))),
            "axes": jax_abstract_params(jcfg)[1],
            "tokens": np.asarray(tokens), "loss": float(loss),
            "grads": {n: np.asarray(g) for n, g in _names(grads)},
            "losses": losses, "grad_norms": norms}


@pytest.fixture(scope="module")
def reference():
    return {arch: _reference(arch) for arch in CASES}


@pytest.fixture(scope="module")
def worlds(reference, tmp_path_factory):
    """world name -> (data, model, archs, rank 0's results), each world
    spawned once, at its first use, for all its cases."""
    done = {}

    def world(name):
        if name not in done:
            (data, model), archs = WORLDS[name]
            cases = [{"arch": arch, "over": CASES[arch][0],
                      "params": reference[arch]["params"],
                      "tokens": reference[arch]["batch"]["tokens"],
                      "gen": GEN, "batch": reference[arch]["batch"]}
                     for arch in archs]
            out = workers.spawn_world(workers.tp_world, data * model,
                                      tmp_path_factory.mktemp(name), data,
                                      model, cases, STEPS)
            done[name] = (data, model, archs, out)
        return done[name]
    return world


def _mesh(data, model):
    """A stand-in ("data", "model") mesh: what ``NamedSharding`` reads."""
    return types.SimpleNamespace(
        mesh_dim_names=("data", "model"),
        mesh=torch.arange(data * model).reshape(data, model))


def _jax_mesh(data, model):
    return types.SimpleNamespace(shape={"data": data, "model": model})


def _jax_rules(arch):
    """The reference's rules of ``arch``'s case."""
    return jax_get_rules(_cfgs(arch)[0].rules)


def _reference_boxes(ref, data, model, arch):
    """leaf name -> rank -> box of the reference's ``param_specs`` under
    the case's rules on a (data, model) mesh, for its params."""
    shapes = ref["params"]
    specs = jax_param_specs(ref["axes"], _jax_rules(arch),
                            _jax_mesh(data, model), shapes)
    flat_specs = dict(_names(specs))
    out = {}
    for name, shape in _names(shapes):
        out[name] = NamedSharding(_mesh(data, model), tuple(
            flat_specs[name])).devices_indices_map(shape.shape)
    return out


def _site_boxes(axes, shape, data, model, arch):
    """rank -> box of an activation of whole ``shape`` with logical
    ``axes`` under the reference's ``spec`` (the case's rules) on a
    (data, model) mesh."""
    s = jax_spec(axes, _jax_rules(arch), _jax_mesh(data, model), shape)
    return NamedSharding(_mesh(data, model), tuple(s)).devices_indices_map(
        shape)


def _rank(coord, model):
    return coord[0] * model + coord[1]


def _close(got, want, name, rtol=1e-5, rel_atol=1e-6):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rel_atol * max(np.abs(want).max(), 1e-30),
                               err_msg=name)


def _cell(world, arch):
    data, model, archs, out = world
    return data, model, archs.index(arch), out


@pytest.mark.parametrize("world, arch", CELLS, ids=CELL_IDS)
def test_param_shards_are_the_reference_boxes(worlds, reference, world, arch):
    data, model, i, out = _cell(worlds(world), arch)
    boxes = _reference_boxes(reference[arch], data, model, arch)
    full = dict(_names(reference[arch]["params"]))
    for res in out["train"]:
        r = _rank(res[i]["coord"], model)
        assert sorted(res[i]["params"]) == sorted(full)
        for name, part in res[i]["params"].items():
            np.testing.assert_array_equal(part, full[name][boxes[name][r]],
                                          err_msg=name)
    # the engine holds the same boxes, but for RWKV-6's head_dim-split
    # leaves, which it holds as the rank's heads, each whole
    cfg = _cfgs(arch)[1]
    for res in out["serve"]["cases"]:
        r = _rank(res[i]["coord"], model)
        for name, shape in res[i]["param_shapes"].items():
            box = tuple(sl.stop - sl.start for sl in boxes[name][r])
            if name.split("/")[-1] in ("u", "gn_scale", "gn_bias"):
                heads = cfg.d_model // cfg.rwkv_head_dim
                box = (*box[:-2], heads // model, cfg.rwkv_head_dim)
            assert shape == box, name


@pytest.mark.parametrize("world, arch", CELLS, ids=CELL_IDS)
def test_prefill_logits_and_cache_match_reference(worlds, reference, world, arch):
    data, model, i, out = _cell(worlds(world), arch)
    ref = reference[arch]
    ranks = out["serve"]["cases"]
    vocab = _cfgs(arch)[1].vocab_size
    lboxes = _site_boxes(("batch", "act_vocab"), ref["logits"].shape, data,
                         model, arch)
    for res in ranks:
        r = _rank(res[i]["coord"], model)
        got, want = res[i]["logits"], ref["logits"][lboxes[r]]
        lo = lboxes[r][1].start
        keep = max(0, min(vocab - lo, got.shape[1]))
        _close(got[:, :keep], want[:, :keep], "logits")
        np.testing.assert_array_equal(got[:, keep:], want[:, keep:])
        assert (got[:, keep:] == np.float32(-1e30)).all()
    whole = ranks[0][i]["whole"]
    for name, want in ref["cache"].items():
        if name == "idx":
            continue
        boxes = _site_boxes(ref["cache_axes"][name], want.shape, data,
                            model, arch)
        # the whole cache restored on one rank is the reference's, and
        # each rank's leaf its box of it
        _close(whole[name], want, name)
        for res in ranks:
            r = _rank(res[i]["coord"], model)
            _close(res[i]["cache"][name], want[boxes[r]], name)
            np.testing.assert_array_equal(whole[name][boxes[r]],
                                          res[i]["cache"][name],
                                          err_msg=name)


@pytest.mark.parametrize("world, arch", CELLS, ids=CELL_IDS)
def test_greedy_tokens_and_restored_decode(worlds, reference, world, arch):
    data, model, i, out = _cell(worlds(world), arch)
    ranks = out["serve"]["cases"]
    ref = reference[arch]
    want = ref["tokens"]
    for r in ranks:
        np.testing.assert_array_equal(r[i]["tokens"], want)
        assert r[i]["restored_equal"]
        np.testing.assert_array_equal(r[i]["restored_decode"], want[:, 1:])
    np.testing.assert_array_equal(ranks[0][i]["whole_decode"], want[:, 1:])
    # one part a distinct box of each leaf, the index whole
    parts = {name: len({tuple((sl.start, sl.stop) for sl in box)
                        for box in _site_boxes(
                            ref["cache_axes"][name], leaf.shape, data,
                            model, arch).values()})
             for name, leaf in ref["cache"].items()}
    assert ranks[0][i]["parts"] == parts
    assert parts["idx"] == 1


@pytest.mark.parametrize("world, arch", CELLS, ids=CELL_IDS)
def test_loss_grads_and_steps_match_reference(worlds, reference, world, arch):
    data, model, i, out = _cell(worlds(world), arch)
    ref = reference[arch]
    boxes = _reference_boxes(ref, data, model, arch)
    for res in out["train"]:
        r = _rank(res[i]["coord"], model)
        np.testing.assert_allclose(res[i]["loss"], ref["loss"], rtol=1e-5)
        assert sorted(res[i]["grads"]) == sorted(ref["grads"])
        for name, g in res[i]["grads"].items():
            want = ref["grads"][name]
            _close(g, want[boxes[name][r]], name,
                   rel_atol=GRAD_ATOL[arch])
        np.testing.assert_allclose(res[i]["losses"], ref["losses"],
                                   rtol=1e-5)
        np.testing.assert_allclose(res[i]["grad_norms"], ref["grad_norms"],
                                   rtol=NORM_RTOL[arch])


@pytest.mark.parametrize("world", sorted(w for w in WORLDS
                                         if WORLDS[w][0][1] > 1))
def test_model_axis_that_does_not_divide_raises(worlds, world):
    """A "model" axis that divides RWKV-6's width but not its heads would
    cut a head's recurrence: tiny rwkv6-7b with one head of 64 raises on
    the world's mesh, naming it."""
    _, _, _, out = worlds(world)
    assert "inside its 1 heads" in out["serve"]["rwkv_raised"]


@pytest.mark.parametrize("arch, size, what", [
    ("yi-6b", 8, "4 kv heads"), ("phi3-medium-14b", 3, "40 heads"),
    ("qwen2.5-3b", 16, "2 kv heads"), ("dbrx-132b", 3, "16 experts"),
    ("qwen3-moe-235b-a22b", 8, "128 experts")])
def test_check_model_axis_names_the_axis(arch, size, what):
    """A size that divides a leaf's flattened width but not the heads
    (``what``) is taken, as the reference's engine takes it: the leaf
    splits inside a head, its site resolves whole, and so does the
    cache; a size that divides neither leaves both whole.  The experts
    (under the MoE configs' ``FSDP_RULES``) split where the size divides
    them, leaf and ``act_experts`` site alike, and are whole where it
    does not: dbrx-132b's 16 at 3, qwen3-moe's 128 at 8 (16 a rank)."""
    cfg = get_config(arch)
    rules = FSDP_RULES if cfg.rules == "fsdp" else TP_RULES
    check_model_axis(cfg, size, rules)
    check_model_axis(cfg, 2, rules)
    n, hd = int(what.split()[0]), cfg.resolved_head_dim
    if "experts" in what:
        assert n == cfg.num_experts
        local = n // size if n % size == 0 else n
        leaf = local_shape(("stack", "experts", "embed", "expert_ff"),
                           (2, n, cfg.d_model, cfg.resolved_moe_d_ff),
                           rules, size)
        site = local_shape(("batch", "act_experts", None, None),
                           (1, n, 4, cfg.d_model), rules, size)
        assert leaf[1] == site[1] == local
        assert local == (16 if arch.startswith("qwen3") else n)
        return
    assert n % size
    kv = "kv" in what
    width = n * hd
    rules_axes = ("embed", "kv_heads") if kv else ("embed", "heads")
    leaf = local_shape(rules_axes, (cfg.d_model, width), TP_RULES, size)
    assert leaf[-1] == (width // size if width % size == 0 else width)
    site = ("batch", "act_kv_heads" if kv else "act_heads", "seq", None)
    assert local_shape(site, (1, n, 1, hd), TP_RULES, size)[1] == n
    cache = init_cache(cfg, 1, 8, device="meta", mesh=_mesh(1, size))
    assert tuple(cache["stack"]["b0"]["self"].k.shape) == (
        cfg.num_layers, 1, cfg.num_kv_heads, 8, hd)


@pytest.mark.parametrize("arch", ["dbrx-132b", "rwkv6-7b",
                                  "recurrentgemma-9b", "seamless-m4t-medium",
                                  "pixtral-12b"])
def test_later_slices_raise(arch):
    """The encoder-decoder, the frontends, ``SEQ_RULES`` and the int8
    cache still raise; MoE splits under both rule sets, and so over
    "data" alone under ``FSDP_RULES``; the recurrent models split over
    "rnn" and raise only where RWKV-6's heads would be cut (64 heads of
    64 over 128 ranks) or for the int8 cache."""
    cfg = get_config(arch)
    if arch == "dbrx-132b":
        for rules in (TP_RULES, FSDP_RULES):
            check_model_axis(cfg, 2, rules)
            check_model_axis(cfg, 4, rules)
            check_model_axis(cfg, 2, rules, data=2)
        check_model_axis(cfg, 1, FSDP_RULES, data=2)
        for data in (1, 2):
            with pytest.raises(ValueError, match="not split"):
                check_model_axis(cfg, 2, SEQ_RULES, data)
    elif arch in RECURRENT:
        check_model_axis(cfg, 2)
        check_model_axis(cfg, 4)
        if arch == "rwkv6-7b":
            with pytest.raises(ValueError, match="inside its 64 heads"):
                check_model_axis(cfg, 128)
        with pytest.raises(ValueError, match="int8"):
            check_model_axis(dataclasses.replace(cfg, kv_quant=True), 2)
    else:
        with pytest.raises(ValueError, match="not split"):
            check_model_axis(cfg, 2)
        # FSDP alone splits every param's embed rows over "data"
        with pytest.raises(ValueError, match="not split"):
            check_model_axis(cfg, 1, FSDP_RULES, data=2)
    cfg = dataclasses.replace(get_config("yi-6b"), kv_quant=True)
    with pytest.raises(ValueError, match="int8"):
        check_model_axis(cfg, 2)
    with pytest.raises(ValueError, match="int8"):
        check_model_axis(cfg, 1, FSDP_RULES, data=2)


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
from repro.sharding import get_rules, use_rules

out = sys.argv[1]
with open(out, "rb") as f:
    cases = pickle.load(f)
res = {}
for shape, arch, over, params, batch, max_len, probe in cases:
    mesh = Mesh(np.asarray(jax.devices()[:shape[0] * shape[1]]).reshape(
        shape), ("data", "model"))
    cfg = dataclasses.replace(get_config(arch, tiny=True), **over)
    rules = get_rules(cfg.rules)
    specs = param_specs(init_params(cfg, jax.random.key(0))[1], rules,
                        mesh, params)
    sharded = jax.tree.map(lambda a, s: jax.device_put(
        a, NamedSharding(mesh, s)), params, specs)

    @jax.jit
    def run(p, b):
        with use_rules(mesh, rules):
            logits, _ = prefill(cfg, p, {"tokens": b["tokens"]},
                                init_cache(cfg, b["tokens"].shape[0],
                                           max_len))
            loss, _ = loss_fn(cfg, p, b, impl="xla")
        return logits, loss
    logits, loss = run(sharded, {k: jnp.asarray(v) for k, v in batch.items()})
    leaf = sharded
    for k in probe:
        leaf = leaf[k]
    res[(shape, arch)] = {"logits": np.asarray(logits), "loss": float(loss),
                          "probe_shard": leaf.addressable_shards[0].data.shape}
with open(out, "wb") as f:
    pickle.dump(res, f)
print("REFERENCE_MESH_OK")
"""

# a column-split leaf of each arch whose shard the reference run reports
PROBES = {"yi-6b": ("stack", "b0", "attn", "wq"),
          "qwen2.5-3b": ("stack", "b0", "attn", "wq"),
          "deepseek-7b": ("stack", "b0", "attn", "wq"),
          "rwkv6-7b": ("stack", "b0", "tm", "w_rkvg"),
          "recurrentgemma-9b": ("stack", "b0", "rec", "w_ig"),
          # experts over "model", embed rows over "data"
          "dbrx-132b": ("stack", "b0", "moe", "w_gu"),
          "qwen3-moe-235b-a22b": ("stack", "b0", "moe", "w_gu")}
# qwen2.5-3b's split at 4 (kv heads inside a head) is yi-6b's
REFERENCE_MESHES = [((2, 2), a) for a in WORLDS["data2_model2"][1]] + [
    ((1, 4), a) for a in ["yi-6b"] + RECURRENT + MOE] + [
    ((2, 1), a) for a in MOE]


def test_reference_under_a_mesh_matches_its_one_device_run(reference,
                                                           tmp_path):
    """The reference partitioned by GSPMD under its case's rules on (2, 2)
    and (1, 4) meshes, and the MoE models under ``FSDP_RULES`` on (2, 1),
    gives the logits and loss of its one-device run, which the port's
    split run is held to above: the split changes no answer.  Each probe
    leaf's shard is its box of the reference's specs (tiny dbrx-132b's
    ``w_gu`` (2, 2, 4, 64, 96) a box of (2, 2, 2, 32, 96) at (2, 2))."""
    out = tmp_path / "mesh.pkl"
    cases = [(shape, arch, CASES[arch][0], reference[arch]["params"],
              reference[arch]["batch"],
              serve_max_len(_cfgs(arch)[1], CASES[arch][1], GEN),
              PROBES[arch]) for shape, arch in REFERENCE_MESHES]
    with open(out, "wb") as f:
        pickle.dump(cases, f)
    proc = subprocess.run([sys.executable, "-c", REFERENCE_MESH, str(out)],
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=600)
    assert "REFERENCE_MESH_OK" in proc.stdout, proc.stdout + proc.stderr
    with open(out, "rb") as f:
        got = pickle.load(f)
    for shape, arch in REFERENCE_MESHES:
        ref = reference[arch]
        vocab = _cfgs(arch)[1].vocab_size
        leaf = ref["params"]
        for k in PROBES[arch]:
            leaf = leaf[k]
        g = got[(shape, arch)]
        box = _reference_boxes(ref, *shape, arch)["/".join(PROBES[arch])][0]
        assert g["probe_shard"] == tuple(sl.stop - sl.start for sl in box)
        assert g["probe_shard"] != leaf.shape
        _close(g["logits"][:, :vocab], ref["logits"][:, :vocab],
               f"{arch} logits on {shape}")
        np.testing.assert_allclose(g["loss"], ref["loss"], rtol=1e-5)
