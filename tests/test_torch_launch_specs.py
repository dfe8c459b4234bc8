"""The port's cell specs (``repro_torch.launch.specs``) held against the
JAX reference's (``repro.launch.specs``), on the CPU with no device mesh:
``spec`` reads only a mesh's ``shape``, so stand-ins of the production
meshes, {data 16, model 16} and {pod 2, data 16, model 16}, resolve here.

* twins of ``tests/test_launch_specs.py``'s five tests;
* twins of ``tests/test_sharding_rules.py``'s ``test_cell_rules_kv_fallback``
  and ``test_default_microbatches``;
* for every architecture and every shape of ``shapes_for`` at full size,
  every leaf of ``input_specs`` (``meta`` tensors) has the shape and dtype
  of the reference's ``ShapeDtypeStruct``, and every ``PartitionSpec`` of
  ``cell_shardings`` equals the reference's at both production meshes
  (the reference's ``NamedSharding`` replaced by a holder of its spec,
  since a jax mesh of 256 devices is not at hand).
"""
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.launch.specs as jax_specs  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro_torch.configs import get_config, get_shape, shapes_for  # noqa: E402
from repro_torch.launch.specs import (cell_rules, cell_shardings,  # noqa: E402
                                      default_microbatches, input_specs)
from repro_torch.sharding import NamedSharding  # noqa: E402

ARCHS = sorted(ARCH_IDS)
MESHES = {"data16_model16": {"data": 16, "model": 16},
          "pod2_data16_model16": {"pod": 2, "data": 16, "model": 16}}
CELLS = [(a, s.name) for a in ARCHS for s in shapes_for(get_config(a))]


def fake_mesh(shape):
    """What ``spec`` reads of a mesh: ``shape``."""
    return types.SimpleNamespace(shape=dict(shape))


def mesh1():
    return fake_mesh({"data": 1, "model": 1})


def flat(tree, path=()):
    """{"/"-joined path: leaf} of a tree of dicts, NamedTuples, lists and
    tuples (either framework's); None subtrees vanish."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "spec"):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {"/".join(path): tree}
    out = {}
    for k, v in items:
        out.update(flat(v, path + (str(k),)))
    return out


def _leaves_match(specs, shardings):
    a = flat(specs)
    b = flat(shardings)
    assert len(a) == len(b), (len(a), len(b))
    assert a.keys() == b.keys()
    assert all(isinstance(s, NamedSharding) for s in b.values())


# --------------------------------------------------------------------------
# twins of tests/test_launch_specs.py
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["yi-6b", "qwen3-moe-235b-a22b",
                                  "seamless-m4t-medium", "pixtral-12b",
                                  "rwkv6-7b", "recurrentgemma-9b"])
def test_train_specs_consistent(arch):
    cfg = get_config(arch)
    shape = get_shape("train_4k")
    specs = input_specs(cfg, shape)
    state, batch = specs
    assert batch["tokens"].shape == (shape.global_batch, shape.seq_len)
    assert all(t.device.type == "meta" for t in flat(specs).values())
    _leaves_match(specs, cell_shardings(cfg, shape, mesh1()))


@pytest.mark.parametrize("arch", ["yi-6b", "rwkv6-7b", "seamless-m4t-medium"])
def test_decode_specs_consistent(arch):
    cfg = get_config(arch)
    shape = get_shape("decode_32k")
    params, cache, tokens = input_specs(cfg, shape)
    assert tokens.shape == (shape.global_batch, 1)
    # serving params are compute-dtype, not f32 masters
    float_dtypes = {t.dtype for t in flat(params).values()
                    if t.is_floating_point()}
    assert float_dtypes == {getattr(torch, cfg.dtype)}
    _leaves_match((params, cache, tokens),
                  cell_shardings(cfg, shape, mesh1()))


def test_prefill_specs_have_no_labels():
    cfg = get_config("yi-6b")
    params, batch, cache = input_specs(cfg, get_shape("prefill_32k"))
    assert "labels" not in batch


def test_long500k_only_for_subquadratic():
    assert "long_500k" in [s.name for s in shapes_for(get_config("rwkv6-7b"))]
    assert "long_500k" not in [s.name for s in
                               shapes_for(get_config("yi-6b"))]


def test_vocab_padding_applies_only_when_needed():
    seam = get_config("seamless-m4t-medium")
    assert seam.padded_vocab == 256256 and seam.vocab_size == 256206
    yi = get_config("yi-6b")
    assert yi.padded_vocab == yi.vocab_size      # 64000 % 256 == 0


# --------------------------------------------------------------------------
# twins of the two cases of tests/test_sharding_rules.py on launch/specs.py
# --------------------------------------------------------------------------
def test_cell_rules_kv_fallback():
    cfg = get_config("yi-6b")           # kv=4, model=16 -> fallback
    mesh = fake_mesh(MESHES["data16_model16"])
    rules = cell_rules(cfg, get_shape("decode_32k"), mesh)
    assert rules.lookup("kv_seq") == "model"
    assert rules.lookup("act_kv_heads") is None
    rules_t = cell_rules(cfg, get_shape("train_4k"), mesh)
    assert rules_t.lookup("kv_seq") is None
    # the reference's rules, leaf for leaf
    for name in ("decode_32k", "train_4k"):
        want = jax_specs.cell_rules(jax_get_config("yi-6b"),
                                    get_shape(name), mesh)
        got = cell_rules(cfg, get_shape(name), mesh)
        assert got.table == want.table and got.fallbacks == want.fallbacks


def test_default_microbatches():
    mesh = fake_mesh(MESHES["data16_model16"])
    cfg = get_config("yi-6b")
    assert default_microbatches(cfg, get_shape("train_4k"), mesh) == 8
    assert default_microbatches(cfg, get_shape("decode_32k"), mesh) == 1
    for m in MESHES.values():
        for shape in shapes_for(cfg):
            assert default_microbatches(cfg, shape, fake_mesh(m)) == \
                jax_specs.default_microbatches(jax_get_config("yi-6b"),
                                               shape, fake_mesh(m))
    assert default_microbatches(cfg, get_shape("train_4k"), fake_mesh(
        MESHES["pod2_data16_model16"])) == 8


# --------------------------------------------------------------------------
# every cell at full size, against the reference
# --------------------------------------------------------------------------
def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


class _Spec:
    """Stands for the reference's ``NamedSharding``: its spec."""

    def __init__(self, mesh, spec):
        self.spec = spec


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_cell_equals_the_reference(arch, shape, monkeypatch):
    cfg, jcfg, shp = get_config(arch), jax_get_config(arch), get_shape(shape)
    want = flat(jax_specs.input_specs(jcfg, shp))
    got = flat(input_specs(cfg, shp))
    assert got.keys() == want.keys()
    for path, t in got.items():
        w = want[path]
        assert tuple(t.shape) == tuple(w.shape), path
        assert _dtype_name(t) == str(jnp.dtype(w.dtype)), path
    monkeypatch.setattr(jax_specs, "NamedSharding", _Spec)
    for mesh in MESHES.values():
        m = fake_mesh(mesh)
        want = {p: tuple(s.spec) for p, s in
                flat(jax_specs.cell_shardings(jcfg, shp, m)).items()}
        got = {p: tuple(s.spec) for p, s in
               flat(cell_shardings(cfg, shp, m)).items()}
        assert got == want
