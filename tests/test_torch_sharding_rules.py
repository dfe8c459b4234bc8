"""The port's logical-axis rules and axes trees held against the JAX
reference, on the CPU with no process group: ``spec`` reads only a mesh's
``shape``, so stand-in meshes of {data 16, model 16} and {pod 2, data 16,
model 16} resolve specs here.

* a twin of every case of ``tests/test_sharding_rules.py`` but the two
  that need ``launch/specs.py``;
* for each of the ten architectures at full size, on the ``meta`` device
  (nothing allocated): ``param_axes`` equal to the reference's
  ``abstract_params(cfg)[1]`` leaf for leaf, and ``param_specs`` under TP,
  FSDP and SEQ on both stand-in meshes equal to the reference's;
* ``cache_axes`` equal, for the bf16 and the int8 caches;
* ``train_state_specs`` of qwen2.5-3b, with and without compressed
  gradients, equal.
"""
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import abstract_params as jax_abstract_params  # noqa: E402
from repro.models import cache_axes as jax_cache_axes  # noqa: E402
from repro.models.params import param_specs as jax_param_specs  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.sharding import get_rules as jax_get_rules  # noqa: E402
from repro.sharding import spec as jax_spec  # noqa: E402
from repro.train.state import (  # noqa: E402
    abstract_train_state as jax_abstract_train_state,
    train_state_specs as jax_train_state_specs)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import (abstract_params, cache_axes,  # noqa: E402
                                map_axes, param_axes, param_shardings,
                                param_specs)
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.sharding import (FSDP_RULES, TP_RULES,  # noqa: E402
                                  NamedSharding, P, PartitionSpec,
                                  active_rules, constrain, get_rules,
                                  placements, spec, use_rules)
from repro_torch.train import (abstract_train_state,  # noqa: E402
                               train_state_specs)

ARCHS = sorted(ARCH_IDS)
MESHES = {"data16_model16": {"data": 16, "model": 16},
          "pod2_data16_model16": {"pod": 2, "data": 16, "model": 16}}


def fake_mesh(shape):
    """What the reference's ``spec`` reads of a mesh: ``shape``."""
    return types.SimpleNamespace(shape=dict(shape))


def mesh2d():
    """The reference tests' one-device (data 1, model 1) mesh."""
    return fake_mesh({"data": 1, "model": 1})


def _is_leaf(x):
    if isinstance(x, PartitionSpec) or type(x).__name__ == "PartitionSpec":
        return True
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, str) for e in x)


def flat(tree, path=()):
    """{"/"-joined path: leaf} of an axes or spec tree of dicts,
    NamedTuples and lists (either framework's); None subtrees vanish."""
    if tree is None:
        return {}
    if _is_leaf(tree):
        return {"/".join(path): tuple(tree)}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        raise TypeError(type(tree))
    out = {}
    for k, v in items:
        out.update(flat(v, path + (str(k),)))
    return out


def shapes_flat(tree, path=()):
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {"/".join(path): tuple(tree.shape)}
    out = {}
    for k, v in items:
        out.update(shapes_flat(v, path + (str(k),)))
    return out


# --------------------------------------------------------------------------
# twins of tests/test_sharding_rules.py
# --------------------------------------------------------------------------
def test_basic_resolution():
    assert spec(("embed", "ff"), TP_RULES) == P(None, "model")
    assert spec(("vocab", "embed"), TP_RULES) == P("model")
    assert spec(("batch", "seq", "act_embed"), TP_RULES) == P(("pod", "data"))


def test_fsdp_shards_embed():
    assert spec(("embed", "ff"), FSDP_RULES) == P(("pod", "data"), "model")


def test_missing_pod_axis_dropped():
    s = spec(("batch", None), TP_RULES, mesh2d(), (8, 4))
    assert s == P("data")


def test_divisibility_fallback_to_replication():
    s = spec(("kv_heads", "head_dim"), TP_RULES, mesh2d(), (4, 128))
    assert s in (P("model"), P())  # 1-sized axes always divide
    # a stand-in model axis of 16 does not divide 4 kv heads: replicated,
    # as the reference resolves it
    big = fake_mesh(MESHES["data16_model16"])
    assert spec(("kv_heads", "head_dim"), TP_RULES, big, (4, 128)) == P()
    ax, dims = ("batch", "act_kv_heads", "kv_seq", None), (16, 4, 4096, 128)
    assert spec(ax, TP_RULES, big, dims) == P("data") == tuple(
        jax_spec(ax, jax_get_rules("tp"), big, dims))


def test_axis_used_once():
    s = spec(("heads", "ff"), TP_RULES)
    # both map to "model": only the first gets it
    assert s == P("model")


def test_with_rule_override():
    # the decode fallback pair: kv-heads replicated, cache seq over model
    r = TP_RULES.with_rule("kv_seq", "model").with_rule("act_kv_heads", None)
    s = spec(("batch", "act_kv_heads", "kv_seq", None), r)
    assert s[1] is None and s[2] == "model"


def test_trailing_nones_trimmed():
    s = spec(("embed", None, None), TP_RULES)
    assert s == P()
    assert P("data", None, None) == ("data",) and P() == ()


def test_rules_tables_equal_the_reference():
    for name in ("tp", "fsdp", "seq"):
        mine, ref = get_rules(name), jax_get_rules(name)
        assert mine.table == ref.table and mine.fallbacks == ref.fallbacks


def test_constrain_leaves_plain_tensors_and_no_mesh_alone():
    x = torch.ones(4, 8)
    assert constrain(x, "batch", "act_ff") is x            # no rules active
    with use_rules(None, TP_RULES):
        assert constrain(x, "batch", "act_ff") is x        # no mesh
    with use_rules(types.SimpleNamespace(shape={"data": 2}), TP_RULES):
        assert active_rules()[1] is TP_RULES
        assert constrain(x, "batch", "act_ff") is x        # a plain tensor
    assert active_rules() is None


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    assert placements(P("data", "model"), mesh) == (Shard(0), Shard(1))
    assert placements(P(None, "data"), mesh) == (Shard(1), Replicate())
    assert placements(P(), mesh) == (Replicate(), Replicate())
    with pytest.raises(ValueError):
        placements(P(("data", "model")), mesh)


def test_named_sharding_without_a_mesh_is_the_whole_array():
    assert NamedSharding(None, P()).devices_indices_map((3, 5)) == {
        0: (slice(0, 3), slice(0, 5))}


# --------------------------------------------------------------------------
# axes trees and specs of the ten architectures at full size
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_equal_the_reference(arch):
    jshapes, jaxes = jax_abstract_params(jax_get_config(arch))
    shapes, axes = abstract_params(get_config(arch))
    assert flat(param_axes(get_config(arch))) == flat(axes)
    assert flat(axes) == flat(jaxes)
    # the meta tensors have the reference's shapes and allocate nothing
    assert shapes_flat(shapes) == shapes_flat(jshapes)
    assert all(t.device.type == "meta"
               for t in _tensors(shapes))


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("rules", ["tp", "fsdp", "seq"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, rules, mesh):
    m = fake_mesh(MESHES[mesh])
    jshapes, jaxes = jax_abstract_params(jax_get_config(arch))
    shapes, axes = abstract_params(get_config(arch))
    want = flat(jax_param_specs(jaxes, jax_get_rules(rules), m, jshapes))
    got = flat(param_specs(axes, get_rules(rules), m, shapes))
    assert got == want
    # without shapes nothing is checked for divisibility
    assert flat(param_specs(axes, get_rules(rules))) == flat(
        jax_param_specs(jaxes, jax_get_rules(rules)))
    shardings = param_shardings(axes, get_rules(rules), m, shapes)
    assert flat(map_axes(lambda ax, s: s.spec, axes, shardings)) == want


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_axes_equal_the_reference(arch, quant):
    jcfg = dataclasses.replace(jax_get_config(arch), kv_quant=quant)
    cfg = dataclasses.replace(get_config(arch), kv_quant=quant)
    assert flat(cache_axes(cfg)) == flat(jax_cache_axes(jcfg))


@pytest.mark.parametrize("compress", [False, True])
def test_train_state_specs_equal_the_reference(compress):
    arch = "qwen2.5-3b"
    jstate, jaxes = jax_abstract_train_state(
        jax_get_config(arch), JaxAdamWConfig(compress_grads=compress))
    state, axes = abstract_train_state(
        get_config(arch), AdamWConfig(compress_grads=compress))
    assert flat(axes) == flat(jaxes)
    assert shapes_flat(state) == shapes_flat(jstate)
    for mesh in MESHES.values():
        m = fake_mesh(mesh)
        want = flat(jax_train_state_specs(jax_get_config(arch), m, jstate,
                                          jaxes))
        got = flat(train_state_specs(get_config(arch), m, state, axes))
        assert got == want
        # the moments are FSDP-sharded on the embed axis where the params
        # are not
        assert got["opt/mu/embed/table"] != got["params/embed/table"]


@pytest.mark.parametrize("arch", ["dbrx-132b", "qwen3-moe-235b-a22b"])
def test_moe_train_state_specs_equal_the_reference(arch):
    """The MoE configurations name ``FSDP_RULES``: their params' specs
    split the experts over "model" and the embed rows over ("pod",
    "data"), as the moments' do, at both production meshes."""
    jstate, jaxes = jax_abstract_train_state(jax_get_config(arch),
                                             JaxAdamWConfig())
    state, axes = abstract_train_state(get_config(arch), AdamWConfig())
    assert flat(axes) == flat(jaxes)
    for mesh in MESHES.values():
        m = fake_mesh(mesh)
        want = flat(jax_train_state_specs(jax_get_config(arch), m, jstate,
                                          jaxes))
        got = flat(train_state_specs(get_config(arch), m, state, axes))
        assert got == want
        w_gu = "stack/b0/moe/w_gu"
        assert got[f"params/{w_gu}"] == got[f"opt/mu/{w_gu}"]
        assert got[f"params/{w_gu}"][2:4] == (
            "model", ("pod", "data") if "pod" in mesh else "data")
