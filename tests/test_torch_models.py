"""The port's attention backbone held against the JAX reference.

Tiny ``yi-6b``, ``qwen2.5-3b``, ``deepseek-7b`` and ``phi3-medium-14b``
(dense), tiny ``dbrx-132b`` and ``qwen3-moe-235b-a22b`` (MoE FFN), and
tiny ``seamless-m4t-medium`` (encoder-decoder, with numpy frames) and
``pixtral-12b`` (with numpy patches), f32, head dim 16, with the reference's parameters carried across by
name (``params_from_numpy``, the ``moe`` subtree too), so both
frameworks run the same weights on the same numpy tokens.  Forward
logits, prefill logits and cache, and each decode step's logits agree to
atol 1e-5, the MoE aux loss to rtol 1e-5 (f32 sums in another order).
The MoE archs' loss (with the aux loss) and gradients match
``jax.grad`` of the reference's.  Parameter counts equal the reference's
for every arch the port builds, also counting only a token's active
experts.  f32 matmuls run in full
precision (``allow_tf32 = False``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.snapshot import leaf_names as jax_leaf_names  # noqa: E402
from repro.models import count_params as jax_count_params  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_cache as jax_init_cache  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import loss_fn as jax_loss_fn  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.snapshot import snapshot_pytree  # noqa: E402
from repro_torch.models import (count_params, decode_step, forward,  # noqa: E402
                                init_cache, init_params, loss_fn, prefill)
from repro_torch.serve import ServeEngine, serve_max_len  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False

ARCHS = ["yi-6b", "qwen2.5-3b", "deepseek-7b", "phi3-medium-14b",
         "dbrx-132b", "qwen3-moe-235b-a22b", "seamless-m4t-medium",
         "pixtral-12b"]
MOE_ARCHS = ["dbrx-132b", "qwen3-moe-235b-a22b"]
# every arch the port builds
PORT_ARCHS = ARCHS + ["rwkv6-7b", "recurrentgemma-9b"]
B, T, GEN = 2, 12, 4
ATOL = 1e-5


def _flat(tree):
    """Leaf name -> host array, through the port's snapshot bridge."""
    return {name: r.parts[0]
            for name, r in snapshot_pytree(tree).regions.items()}


def _jax_flat(tree):
    leaves = jax.tree_util.tree_leaves(tree)
    return dict(zip(jax_leaf_names(tree), leaves))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(cfg, jax params, port params on the CPU) for one tiny arch."""
    jcfg = jax_get_config(request.param, tiny=True)
    cfg = get_config(request.param, tiny=True)
    jparams, _ = jax_init_params(jcfg, jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _inputs(cfg, seed, shape):
    """numpy tokens of ``shape``, and the frames (encoder-decoder) or
    patches (VLM) the config's frontend takes."""
    batch = {"tokens": _tokens(cfg, seed, shape)}
    rng = np.random.default_rng(seed + 100)
    if cfg.frontend == "frames":
        batch["frames"] = rng.standard_normal(
            (shape[0], cfg.num_frames, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "patches":
        batch["patches"] = rng.standard_normal(
            (shape[0], cfg.num_patches, cfg.d_model)).astype(np.float32)
    return batch


def _port(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_param_tree_matches_reference(pair):
    jcfg, cfg, jparams, _ = pair
    mine = _flat(init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    ref = _jax_flat(jparams)
    assert list(mine) == list(ref)
    for name in ref:
        assert tuple(mine[name].shape) == tuple(ref[name].shape), name
        assert mine[name].dtype == np.float32


@pytest.mark.parametrize("arch", PORT_ARCHS)
def test_count_params_full_size(arch):
    """All parameters, and those a token activates (MoE experts scaled
    by k/E)."""
    for active_only in (False, True):
        assert count_params(get_config(arch), active_only) == \
            jax_count_params(jax_get_config(arch), active_only)


@pytest.mark.parametrize("arch", PORT_ARCHS)
def test_count_params_tiny(arch):
    for active_only in (False, True):
        assert count_params(get_config(arch, tiny=True), active_only) == \
            jax_count_params(jax_get_config(arch, tiny=True), active_only)


def test_params_from_numpy_carries_the_moe_subtree(pair):
    """Every leaf of the reference's tree, the ``moe`` subtree's too,
    arrives under its name with its values."""
    jcfg, cfg, jparams, params = pair
    mine, ref = _flat(params), _jax_flat(jparams)
    assert list(mine) == list(ref)
    for name in ref:
        assert mine[name].tobytes() == np.asarray(ref[name]).tobytes(), name
    moe_leaves = [n for n in ref if "/moe/" in n]
    if cfg.ffn == "moe":
        assert sorted(moe_leaves) == ["stack/b0/moe/router",
                                      "stack/b0/moe/w_down",
                                      "stack/b0/moe/w_gu"]
    else:
        assert not moe_leaves


def test_forward_matches_reference(pair):
    jcfg, cfg, jparams, params = pair
    batch = _inputs(cfg, 1, (B, T))
    want, jaux = jax_forward(jcfg, jparams, batch)
    got, aux = forward(cfg, params, _port(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    assert (float(aux) > 0) == (cfg.ffn == "moe")


@pytest.mark.parametrize("arch,remat", [("dbrx-132b", "full"),
                                        ("qwen3-moe-235b-a22b", "none")])
def test_moe_loss_and_grads_match_reference(arch, remat):
    """The MoE archs' loss (cross-entropy plus the layers' aux loss) and
    every gradient leaf against ``jax.grad`` of the reference's
    ``loss_fn``, one with full remat (each layer's routing recomputed in
    the backward) and one without: rtol 1e-5, each leaf also atol 1e-6 of
    its largest gradient (the dense archs' tolerances in
    test_torch_train.py)."""
    jcfg, cfg = (dataclasses.replace(get(arch, tiny=True),
                                     remat_policy=remat)
                 for get in (jax_get_config, get_config))
    jparams, _ = jax_init_params(jcfg, jax.random.key(1))
    toks = _tokens(cfg, 4, (B, T))
    labels = toks.copy()
    labels[:, -2:] = -1
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(jcfg, p, {"tokens": toks, "labels": labels},
                              impl="xla"), has_aux=True))(jparams)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    leaves = dict(_named(params))
    for t in leaves.values():
        t.requires_grad_()
    loss, m = loss_fn(cfg, params, {"tokens": torch.from_numpy(toks),
                                    "labels": torch.from_numpy(labels)})
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]),
                               rtol=1e-5)
    assert float(m["aux"]) > 0
    for name, w in _jax_flat(jgrads).items():
        w = np.asarray(w)
        np.testing.assert_allclose(
            leaves[name].grad.numpy(), w, rtol=1e-5,
            atol=1e-6 * float(np.abs(w).max()), err_msg=name)


def _named(tree, prefix=""):
    """(leaf name, tensor) for every leaf of a params tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def test_prefill_and_decode_match_reference(pair):
    jcfg, cfg, jparams, params = pair
    batch = _inputs(cfg, 2, (B, T))
    max_len = serve_max_len(cfg, T, GEN)
    prefix = max_len - T - GEN               # the VLM's patches
    jlogits, jcache = jax_prefill(jcfg, jparams, batch,
                                  jax_init_cache(jcfg, B, max_len))
    cache = init_cache(cfg, B, max_len, device="cpu")
    logits, cache = prefill(cfg, params, _port(batch), cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL)

    def check_cache():
        mine, ref = _flat(cache), _jax_flat(jcache)
        assert list(mine) == list(ref)
        for name in ref:
            np.testing.assert_allclose(mine[name], np.asarray(ref[name]),
                                       atol=ATOL, err_msg=name)

    check_cache()
    assert int(cache["idx"]) == prefix + T
    step_toks = _tokens(cfg, 3, (GEN, B, 1))
    for i in range(GEN):
        jlogits, jcache = jax_decode_step(jcfg, jparams, jcache,
                                          step_toks[i])
        logits, cache = decode_step(cfg, params, cache,
                                    torch.from_numpy(step_toks[i]))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=ATOL, err_msg=f"decode step {i}")
    check_cache()
    assert int(cache["idx"]) == prefix + T + GEN


def test_generation_self_consistent():
    """Greedy tokens re-scored by the full forward are the argmax at each
    position (decode path == forward path); the port's own twin of the
    reference's test on tiny yi-6b."""
    cfg = get_config("yi-6b", tiny=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b, t, gen = 2, 16, 8
    toks = _tokens(cfg, 11, (b, t))
    eng = ServeEngine(cfg, params, max_len=serve_max_len(cfg, t, gen),
                      device="cpu")
    out = eng.generate({"tokens": toks}, gen_len=gen)
    assert out.shape == (b, gen) and out.dtype == np.int32
    full = torch.from_numpy(np.concatenate([toks, out], axis=1))
    logits, _ = forward(cfg, params, {"tokens": full})
    rescored = torch.argmax(logits, -1).numpy()
    np.testing.assert_array_equal(out[:, 1:], rescored[:, t:t + gen - 1])
