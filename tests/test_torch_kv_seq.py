"""The KV cache split over its sequence across the "model" axis (the
serving cells' ``kv_seq`` fallback, ``launch/specs.cell_rules``) against
the JAX reference, on the CPU.

Where the kv heads do not divide "model", ``cell_rules`` drops
``act_kv_heads`` and maps ``kv_seq`` to "model": each rank holds a
contiguous box of the cache's slots (of a sliding-window ring's too), and
decode's softmax statistics and PV products reduce over the ranks.  The
port serves under those rules in gloo worlds (``torch_dp_workers.
kv_seq_serve``: ``init_cache(mesh=, rules=)``, ``prefill``,
``decode_step``); the reference runs ``prefill`` / ``decode_step``
jitted under ``use_rules(mesh, cell_rules(...))`` on forced host devices
in a subprocess, and first against its own one-device run.

Cases: tiny yi-6b and qwen2.5-3b (2 kv heads) at "model" 4, whose last
rank's slots are all masked through every step; tiny phi3-medium-14b (5
kv heads) at "model" 2; tiny recurrentgemma-9b (1 kv head) at "model" 2
and 4, a 20-token prompt over its window of 16, so the ring rolls and
wraps; tiny qwen3-moe under ``FSDP_RULES`` at ("data" 1, "model" 4).
Held: each rank's cache leaves (after prefill and after the decode
steps) are its box of the reference's ``cache_axes`` under ``cell_rules``
(shapes exact), prefill and every decode step's logits within rtol 1e-5
(atol 1e-6 of the leaf's largest value), the greedy tokens equal.
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

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShapeConfig  # noqa: E402
from repro.launch.specs import cell_rules as jax_cell_rules  # noqa: E402
from repro.sharding import spec as jax_spec  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch.specs import cell_rules  # noqa: E402
from repro_torch.models import init_cache  # noqa: E402
from repro_torch.models.attention import KVSeqShard  # noqa: E402
from repro_torch.sharding import NamedSharding, TP_RULES  # noqa: E402
from repro_torch.sharding.tp import kv_seq_rules  # noqa: E402
from repro_torch.sharding.tp import check_model_axis  # noqa: E402

import torch_dp_workers as workers  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B, STEPS = 4, 4
# arch -> (config overrides, prompt tokens, cache slots)
CASES = {"yi-6b": ({}, 12, 24),
         "qwen2.5-3b": ({}, 12, 24),
         "phi3-medium-14b": ({}, 12, 24),
         # the window of 16 is the ring's length: a 20-token prompt rolls it
         "recurrentgemma-9b": ({}, 20, 32),
         "qwen3-moe-235b-a22b": ({"rules": "fsdp"}, 12, 24)}
# world -> ((data, model), its archs)
WORLDS = {"model4": ((1, 4), ["yi-6b", "qwen2.5-3b", "recurrentgemma-9b",
                              "qwen3-moe-235b-a22b"]),
          "model2": ((1, 2), ["phi3-medium-14b", "recurrentgemma-9b"])}
CELLS = [(w, a) for w in sorted(WORLDS) for a in WORLDS[w][1]]
CELL_IDS = [f"{w}-{a}" for w, a in CELLS]
DECODE = ShapeConfig("decode", "decode", 1, 1)

REFERENCE = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
sys.path.insert(0, "src")
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.launch.specs import _tree_shardings, cell_rules
from repro.models import (cache_axes, decode_step, init_cache, init_params,
                          param_specs, prefill)
from repro.sharding import use_rules

path = sys.argv[1]
with open(path, "rb") as f:
    cases = pickle.load(f)


def run(cfg, params, toks, max_len, steps, mesh=None, rules=None):
    cache = init_cache(cfg, toks.shape[0], max_len)
    if mesh is not None:
        p_sh = jax.tree.map(lambda s: NamedSharding(mesh, s), param_specs(
            init_params(cfg, jax.random.key(0))[1], rules, mesh, params),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        c_sh = _tree_shardings(cache_axes(cfg), cache, rules, mesh)
        params = jax.device_put(params, p_sh)
        cache = jax.device_put(cache, c_sh)
        jit = lambda f: jax.jit(f, out_shardings=(None, c_sh))

        def scoped(f):
            def g(*a):
                with use_rules(mesh, rules):
                    return f(*a)
            return g
    else:
        jit, scoped = jax.jit, (lambda f: f)
    pre = jit(scoped(lambda p, t, c: prefill(cfg, p, {"tokens": t}, c)))
    dec = jit(scoped(lambda p, c, t: decode_step(cfg, p, c, t)))
    logits, cache = pre(params, jnp.asarray(toks), cache)
    out = {"logits": [np.asarray(logits)], "tokens": []}
    out["cache_prefill"] = jax.tree.map(np.asarray, cache)
    for _ in range(steps):
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        out["tokens"].append(np.asarray(tok))
        logits, cache = dec(params, cache, tok)
        out["logits"].append(np.asarray(logits))
    out["cache"] = jax.tree.map(np.asarray, cache)
    return out


res = {}
for shape, arch, over, t, max_len, steps in cases:
    cfg = dataclasses.replace(get_config(arch, tiny=True), **over)
    params = init_params(cfg, jax.random.key(0))[0]
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, t)).astype(np.int32)
    mesh = Mesh(np.asarray(jax.devices()[:shape[0] * shape[1]]).reshape(
        shape), ("data", "model"))
    rules = cell_rules(cfg, ShapeConfig("decode", "decode", 1, 1), mesh)
    res[(shape, arch)] = {
        "params": jax.tree.map(np.asarray, params), "tokens_in": toks,
        "kv_seq": rules.lookup("kv_seq"),
        "one": run(cfg, params, toks, max_len, steps),
        "mesh": run(cfg, params, toks, max_len, steps, mesh, rules)}
with open(path, "wb") as f:
    pickle.dump(res, f)
print("REFERENCE_OK")
"""


def _cfgs(arch):
    over = CASES[arch][0]
    return (dataclasses.replace(jax_get_config(arch, tiny=True), **over),
            dataclasses.replace(get_config(arch, tiny=True), **over))


def _names(tree, path=()):
    """("/"-joined path, leaf) of a dict / NamedTuple / list tree, sorted
    keys, None fields skipped (``torch_dp_workers.walk``'s names)."""
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


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(mesh shape, arch) -> the reference's params, prompt, and its
    one-device and mesh runs (``REFERENCE``, one subprocess)."""
    path = tmp_path_factory.mktemp("ref") / "cases.pkl"
    cases = [(WORLDS[w][0], a, CASES[a][0], CASES[a][1], CASES[a][2], STEPS)
             for w, a in CELLS]
    with open(path, "wb") as f:
        pickle.dump(cases, f)
    proc = subprocess.run([sys.executable, "-c", REFERENCE, str(path)],
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=900)
    assert "REFERENCE_OK" in proc.stdout, proc.stdout + proc.stderr[-4000:]
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def worlds(reference, tmp_path_factory):
    """world name -> every rank's results, each world spawned once."""
    done = {}

    def world(name):
        if name not in done:
            shape, archs = WORLDS[name]
            cases = [{"arch": a, "over": CASES[a][0],
                      "params": reference[(shape, a)]["params"],
                      "tokens": reference[(shape, a)]["tokens_in"],
                      "max_len": CASES[a][2], "steps": STEPS}
                     for a in archs]
            done[name] = workers.spawn_world(
                workers.kv_seq_serve, shape[0] * shape[1],
                tmp_path_factory.mktemp(name), shape[0], shape[1], cases)
        return done[name]
    return world


def _close(got, want, name, rtol=1e-5, rel_atol=1e-6):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rel_atol * max(np.abs(want).max(), 1e-30),
                               err_msg=name)


def _boxes(axes, shape, mesh_shape, arch):
    """rank -> box of an array of whole ``shape`` with logical ``axes``
    under the reference's ``cell_rules`` on a (data, model) mesh."""
    data, model = mesh_shape
    jmesh = types.SimpleNamespace(shape={"data": data, "model": model})
    rules = jax_cell_rules(_cfgs(arch)[0], JaxShapeConfig(
        "decode", "decode", 1, 1), jmesh)
    s = jax_spec(axes, rules, jmesh, shape)
    mesh = types.SimpleNamespace(
        mesh_dim_names=("data", "model"),
        mesh=torch.arange(data * model).reshape(data, model))
    return NamedSharding(mesh, tuple(s)).devices_indices_map(shape)


def _cache_axes(arch):
    from repro.models import cache_axes

    return dict(_axes_names(cache_axes(_cfgs(arch)[0])))


@pytest.mark.parametrize("world, arch", CELLS, ids=CELL_IDS)
def test_reference_under_the_mesh_matches_its_one_device_run(
        reference, world, arch):
    """The reference partitioned by GSPMD under ``cell_rules`` (its cache
    over ``kv_seq``) gives its one-device run's logits, tokens and
    cache: the split changes no answer."""
    ref = reference[(WORLDS[world][0], arch)]
    assert ref["kv_seq"] == "model"
    one, mesh = ref["one"], ref["mesh"]
    for i, (a, b) in enumerate(zip(mesh["logits"], one["logits"])):
        _close(a, b, f"{arch} logits {i}")
    for a, b in zip(mesh["tokens"], one["tokens"]):
        np.testing.assert_array_equal(a, b)
    for key in ("cache_prefill", "cache"):
        want = dict(_names(one[key]))
        for name, got in _names(mesh[key]):
            _close(got, want[name], f"{arch} {key} {name}")


@pytest.mark.parametrize("world, arch", CELLS, ids=CELL_IDS)
def test_cache_boxes_logits_and_tokens_match_the_reference(
        worlds, reference, world, arch):
    shape = WORLDS[world][0]
    data, model = shape
    ref = reference[(shape, arch)]["mesh"]
    ranks = worlds(world)
    i = WORLDS[world][1].index(arch)
    axes = _cache_axes(arch)
    kv = sorted(n.rsplit("/", 1)[0] for n in axes if n.endswith("/k"))
    for r, results in enumerate(ranks):
        res = results[i]
        d, m = res["coord"]
        assert d * model + m == r
        # every attention layer's cache is split over its slots
        assert res["seq_split"] == kv, (res["seq_split"], kv)
        for key in ("cache_prefill", "cache"):
            want = dict(_names(ref[key]))
            for name, got in res[key].items():
                if name == "idx":
                    np.testing.assert_array_equal(got, want[name])
                    continue
                box = _boxes(axes[name], want[name].shape, shape, arch)[r]
                exp = want[name][box]
                assert got.shape == exp.shape, (name, got.shape, exp.shape)
                if name.endswith(("/k", "/v")) and name.rsplit(
                        "/", 1)[0] in kv:
                    # the box is a run of slots, a model rank's share
                    assert got.shape[-2] * model == want[name].shape[-2]
                _close(got, exp, f"{arch} rank {r} {key} {name}")
        vbox = None
        for step, (got, want) in enumerate(zip(res["logits"],
                                               ref["logits"])):
            vbox = _boxes(("batch", "act_vocab"), want.shape, shape,
                          arch)[r]
            _close(got, want[vbox], f"{arch} rank {r} logits {step}")
        assert len(res["logits"]) == STEPS + 1
        rows = vbox[0]
        for got, want in zip(res["tokens"], ref["tokens"]):
            np.testing.assert_array_equal(got, want[rows])
    # the last rank of "model" 4 holds slots past every written position
    # in the dense cases: all masked, it adds zeros
    if model == 4 and arch != "recurrentgemma-9b":
        t, max_len = CASES[arch][1], CASES[arch][2]
        assert t + STEPS <= (model - 1) * max_len // model


def test_init_cache_splits_only_where_the_slots_divide():
    """Under ``cell_rules`` a cache of slots that "model" divides holds
    the rank's slots; one it does not divide is whole, as the
    reference's spec replicates it; the config's rules keep it whole."""
    cfg = get_config("qwen2.5-3b", tiny=True)
    mesh = types.SimpleNamespace(
        mesh_dim_names=("data", "model"), mesh=torch.arange(4).reshape(1, 4),
        get_local_rank=lambda name: 0)
    rules = cell_rules(cfg, DECODE, types.SimpleNamespace(
        shape={"data": 1, "model": 4}))
    assert rules == kv_seq_rules(TP_RULES)
    split = init_cache(cfg, 2, 24, device="meta", mesh=mesh, rules=rules)
    kv = split["stack"]["b0"]["self"]
    assert isinstance(kv, KVSeqShard) and kv.k.shape[-2] == 6
    whole = init_cache(cfg, 2, 22, device="meta", mesh=mesh, rules=rules)
    kv = whole["stack"]["b0"]["self"]
    assert not isinstance(kv, KVSeqShard) and kv.k.shape[-2] == 22
    kv = init_cache(cfg, 2, 24, device="meta", mesh=mesh)["stack"]["b0"][
        "self"]
    assert not isinstance(kv, KVSeqShard) and kv.k.shape[-2] == 24


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "pixtral-12b",
                                  "yi-6b"])
def test_kv_seq_rules_pass_the_split_check_but_later_slices_raise(arch):
    """``check_model_axis`` takes the serving cells' rules on ``TP_RULES``
    and ``FSDP_RULES``, and still raises for the encoder-decoder and the
    frontends, the int8 cache and ``SEQ_RULES``."""
    from repro_torch.sharding import FSDP_RULES, SEQ_RULES

    cfg = get_config(arch)
    for base in (TP_RULES, FSDP_RULES):
        rules = kv_seq_rules(base)
        if cfg.frontend != "token":
            with pytest.raises(ValueError, match="not split"):
                check_model_axis(cfg, 4, rules)
        else:
            check_model_axis(cfg, 4, rules)
            check_model_axis(cfg, 4, rules, data=2)
        with pytest.raises(ValueError, match="int8"):
            check_model_axis(dataclasses.replace(cfg, kv_quant=True), 4,
                             rules)
    with pytest.raises(ValueError, match="not split"):
        check_model_axis(cfg, 4, kv_seq_rules(SEQ_RULES))
