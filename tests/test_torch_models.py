"""The port's dense backbone held against the JAX reference.

Tiny ``yi-6b``, ``qwen2.5-3b``, ``deepseek-7b`` and ``phi3-medium-14b``
(f32, head dim 16), with the reference's parameters carried across by
name (``params_from_numpy``), so both frameworks run the same weights on
the same numpy tokens.  Prefill logits and cache, and each
decode step's logits, agree to atol 1e-5 (f32 sums in another order).
f32 matmuls run in full precision (``allow_tf32 = False``).
"""
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
from repro.models import prefill as jax_prefill  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.snapshot import snapshot_pytree  # noqa: E402
from repro_torch.models import (count_params, decode_step, forward,  # noqa: E402
                                init_cache, init_params, prefill)
from repro_torch.serve import ServeEngine, serve_max_len  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False

ARCHS = ["yi-6b", "qwen2.5-3b", "deepseek-7b", "phi3-medium-14b"]
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


def test_param_tree_matches_reference(pair):
    jcfg, cfg, jparams, _ = pair
    mine = _flat(init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    ref = _jax_flat(jparams)
    assert list(mine) == list(ref)
    for name in ref:
        assert tuple(mine[name].shape) == tuple(ref[name].shape), name
        assert mine[name].dtype == np.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_full_size(arch):
    assert count_params(get_config(arch)) == \
        jax_count_params(jax_get_config(arch))


def test_forward_matches_reference(pair):
    jcfg, cfg, jparams, params = pair
    toks = _tokens(cfg, 1, (B, T))
    want, _ = jax_forward(jcfg, jparams, {"tokens": toks})
    got, aux = forward(cfg, params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert float(aux) == 0.0


def test_prefill_and_decode_match_reference(pair):
    jcfg, cfg, jparams, params = pair
    toks = _tokens(cfg, 2, (B, T))
    max_len = T + GEN
    jlogits, jcache = jax_prefill(jcfg, jparams, {"tokens": toks},
                                  jax_init_cache(jcfg, B, max_len))
    cache = init_cache(cfg, B, max_len, device="cpu")
    logits, cache = prefill(cfg, params, {"tokens": torch.from_numpy(toks)},
                            cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL)

    def check_cache():
        mine, ref = _flat(cache), _jax_flat(jcache)
        assert list(mine) == list(ref)
        for name in ref:
            np.testing.assert_allclose(mine[name], np.asarray(ref[name]),
                                       atol=ATOL, err_msg=name)

    check_cache()
    assert int(cache["idx"]) == T
    step_toks = _tokens(cfg, 3, (GEN, B, 1))
    for i in range(GEN):
        jlogits, jcache = jax_decode_step(jcfg, jparams, jcache,
                                          step_toks[i])
        logits, cache = decode_step(cfg, params, cache,
                                    torch.from_numpy(step_toks[i]))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=ATOL, err_msg=f"decode step {i}")
    check_cache()
    assert int(cache["idx"]) == T + GEN


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
