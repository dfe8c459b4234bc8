"""The port's encoder-decoder (seamless-m4t-medium: audio frames through a
non-causal encoder, cross-attention in every decoder layer) and its
patches frontend (pixtral-12b: projected vision patches before the
prompt) held against the JAX reference.

Tiny configs, f32, with the reference's parameters carried across by name
(``params_from_numpy``), and numpy tokens, frames and patches handed to
both.  Tolerances:

* forward logits, prefill logits and cache, and three decode steps'
  logits against the reference's jitted ``prefill`` / ``decode_step``:
  atol 1e-5 (f32 sums in another order);
* the loss rtol 1e-5, every gradient leaf rtol 1e-5 plus atol 1e-6 of its
  largest element (``test_torch_train.py``'s), with full remat and
  without; the encoder's leaves get their gradients through every
  decoder layer's cross-attention K/V;
* the port's own prefill + decode against its teacher-forced forward:
  atol 2e-3 (the reference's ``test_decode_matches_forward``);
* ``attn_apply`` with ``xkv`` and ``causal=False``, ``cross_kv`` and
  ``attn_decode(cross=True)`` (exact and int8 cross caches) against the
  reference's functions: atol 1e-5.

f32 matmuls run in full precision (``allow_tf32 = False``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.snapshot import leaf_names as jax_leaf_names  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_cache as jax_init_cache  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import loss_fn as jax_loss_fn  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.snapshot import snapshot_pytree  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import (count_params, decode_step, forward,  # noqa: E402
                                init_cache, init_params, loss_fn, prefill)
from repro_torch.models.transformer import stack_plan  # noqa: E402
from repro_torch.serve import serve_max_len  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False

ARCHS = ["seamless-m4t-medium", "pixtral-12b"]
B, T, GEN = 2, 12, 3
ATOL = 1e-5


def _flat(tree):
    """Leaf name -> host array, through the port's snapshot bridge."""
    return {name: r.parts[0]
            for name, r in snapshot_pytree(tree).regions.items()}


def _jax_flat(tree):
    return dict(zip(jax_leaf_names(tree), jax.tree_util.tree_leaves(tree)))


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def make_batch(cfg, seed, b=B, t=T):
    """numpy tokens and labels, and the frames or patches the config's
    frontend takes."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks.copy()}
    if cfg.frontend == "frames":
        batch["frames"] = rng.standard_normal(
            (b, cfg.num_frames, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "patches":
        batch["patches"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax cfg, cfg, jax params, port params on the CPU)."""
    jcfg = jax_get_config(request.param, tiny=True)
    cfg = get_config(request.param, tiny=True)
    jparams, _ = jax_init_params(jcfg, jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


def test_stack_plan_matches_reference(pair):
    from repro.models.transformer import stack_plan as jax_stack_plan

    jcfg, cfg, _, _ = pair
    assert stack_plan(cfg) == jax_stack_plan(jcfg)
    assert stack_plan(cfg)["enc_layers"] == cfg.encoder_layers


def test_param_tree_matches_reference(pair):
    jcfg, cfg, jparams, params = pair
    mine = _flat(init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    ref = _jax_flat(jparams)
    assert list(mine) == list(ref)
    for name in ref:
        assert tuple(mine[name].shape) == tuple(ref[name].shape), name
        assert mine[name].dtype == np.float32
    # and params_from_numpy carries every leaf across, bytes and all
    carried = _flat(params)
    assert list(carried) == list(ref)
    for name in ref:
        assert carried[name].tobytes() == \
            np.asarray(ref[name]).tobytes(), name
    want = {"frontend/proj"}
    if cfg.is_encdec:
        want |= {"enc/b0/attn/wq", "enc_norm/scale", "stack/b0/norm_x/scale",
                 "stack/b0/xattn/wkv"}
    assert want <= set(ref)


def test_forward_matches_reference(pair):
    jcfg, cfg, jparams, params = pair
    batch = make_batch(cfg, 1)
    want, _ = jax_forward(jcfg, jparams, batch)
    got, aux = forward(cfg, params, _torch(batch))
    assert got.shape == (B, T, cfg.padded_vocab)     # no patch rows
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert float(aux) == 0.0


@pytest.mark.parametrize("remat", ["full", "none"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, remat):
    jcfg, cfg = (dataclasses.replace(get(arch, tiny=True),
                                     remat_policy=remat)
                 for get in (jax_get_config, get_config))
    jparams, _ = jax_init_params(jcfg, jax.random.key(1))
    batch = make_batch(cfg, 4)
    batch["labels"][:, -2:] = -1
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(jcfg, p, batch, impl="xla"),
        has_aux=True))(jparams)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    leaves = dict(_named(params))
    for t in leaves.values():
        t.requires_grad_()
    loss, _ = loss_fn(cfg, params, _torch(batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    ref = _jax_flat(jgrads)
    assert sorted(ref) == sorted(leaves)
    for name, w in ref.items():
        w = np.asarray(w)
        g = leaves[name].grad
        assert g is not None, name
        np.testing.assert_allclose(
            g.numpy(), w, rtol=1e-5, atol=1e-6 * float(np.abs(w).max()),
            err_msg=name)
    if cfg.is_encdec:
        for name in ("enc/b0/attn/wq", "enc_norm/scale", "frontend/proj"):
            assert float(leaves[name].grad.abs().max()) > 0, name


def test_prefill_and_decode_match_reference(pair):
    jcfg, cfg, jparams, params = pair
    batch = make_batch(cfg, 2)
    del batch["labels"]
    max_len = serve_max_len(cfg, T, GEN)
    jlogits, jcache = jax.jit(
        lambda p, b, c: jax_prefill(jcfg, p, b, c))(
            jparams, batch, jax_init_cache(jcfg, B, max_len))
    cache = init_cache(cfg, B, max_len, device="cpu")
    logits, cache = prefill(cfg, params, _torch(batch), cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL)
    prefix = cfg.num_patches if cfg.frontend == "patches" else 0
    assert int(cache["idx"]) == int(jcache["idx"]) == prefix + T

    def check_cache():
        mine, ref = _flat(cache), _jax_flat(jcache)
        assert list(mine) == list(ref)
        for name in ref:
            np.testing.assert_allclose(mine[name], np.asarray(ref[name]),
                                       atol=ATOL, err_msg=name)
        return mine

    names = check_cache()
    if cfg.is_encdec:
        assert "stack/b0/cross/k" in names
        assert names["stack/b0/cross/k"].shape[3] == cfg.num_frames
    dec = jax.jit(lambda p, c, t: jax_decode_step(jcfg, p, c, t))
    step_toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (GEN, B, 1)).astype(np.int32)
    for i in range(GEN):
        jlogits, jcache = dec(jparams, jcache, step_toks[i])
        logits, cache = decode_step(cfg, params, cache,
                                    torch.from_numpy(step_toks[i]))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=ATOL, err_msg=f"decode step {i}")
    check_cache()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Teacher forcing: the port's prefill of the first half and decode of
    the next tokens give the logits of its full forward (the reference's
    ``tests/test_models_smoke.py::test_decode_matches_forward``)."""
    cfg = get_config(arch, tiny=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _torch(make_batch(cfg, 5, t=16))
    with torch.no_grad():
        logits_all, _ = forward(cfg, params, batch)
        prompt = {k: (v[:, :8] if k == "tokens" else v)
                  for k, v in batch.items() if k != "labels"}
        cache = init_cache(cfg, B, serve_max_len(cfg, 16), device="cpu")
        lg, cache = prefill(cfg, params, prompt, cache)
        np.testing.assert_allclose(lg.numpy(), logits_all[:, 7].numpy(),
                                   atol=2e-3)
        for i in range(8, 11):
            lg, cache = decode_step(cfg, params, cache,
                                    batch["tokens"][:, i:i + 1])
            np.testing.assert_allclose(lg.numpy(), logits_all[:, i].numpy(),
                                       atol=2e-3, err_msg=f"step {i}")


def _attn_params(seed, d, hq, hkv, hd):
    jp, _ = jax_attn.attn_init(jax.random.key(seed), d, hq, hkv, hd,
                               cross=True)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def test_cross_attn_apply_matches_reference():
    """``xkv`` of another length than ``x`` (S 24 frames, T 10 queries and
    T 40), GQA 4/2: no RoPE, no causal mask, whatever ``causal`` says."""
    d, hq, hkv, hd = 32, 4, 2, 8
    jp, p = _attn_params(0, d, hq, hkv, hd)
    rng = np.random.default_rng(0)
    xkv = rng.standard_normal((2, 24, d)).astype(np.float32)
    kw = dict(num_heads=hq, num_kv_heads=hkv, head_dim=hd)
    for t in (10, 40):
        x = rng.standard_normal((2, t, d)).astype(np.float32)
        for causal in (False, True):
            want = jax_attn.attn_apply(jp, jnp.asarray(x), xkv=jnp.asarray(
                xkv), causal=causal, use_rope=False, impl="xla", **kw)
            got = attn.attn_apply(p, torch.from_numpy(x),
                                  xkv=torch.from_numpy(xkv), causal=causal,
                                  use_rope=False, **kw)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=ATOL)
    # the encoder's self-attention: non-causal, RoPE'd
    x = rng.standard_normal((2, 24, d)).astype(np.float32)
    want = jax_attn.attn_apply(jp, jnp.asarray(x), causal=False, impl="xla",
                               **kw)
    got = attn.attn_apply(p, torch.from_numpy(x), causal=False, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("quant", [False, True])
def test_cross_decode_matches_reference(quant):
    """``cross_kv`` fills the static cache (int8 codes and f16 scales with
    ``quant``, through ``_q8``), and ``attn_decode(cross=True)`` reads it
    without inserting, q without RoPE, every slot valid."""
    d, hq, hkv, hd = 32, 4, 2, 8
    jp, p = _attn_params(1, d, hq, hkv, hd)
    rng = np.random.default_rng(1)
    enc = rng.standard_normal((2, 24, d)).astype(np.float32)
    jc = jax_attn.cross_kv(jp, jnp.asarray(enc), hkv, hd, jnp.float32)
    c = attn.cross_kv(p, torch.from_numpy(enc), hkv, hd, torch.float32)
    np.testing.assert_allclose(c.k.numpy(), np.asarray(jc.k), atol=ATOL)
    np.testing.assert_allclose(c.v.numpy(), np.asarray(jc.v), atol=ATOL)
    if quant:
        # the reference serves under jit, where its scales are the ones
        # the port's _q8 gives bit for bit
        q8 = jax.jit(jax_attn._q8)
        (kq, ks), (vq, vs) = q8(jc.k), q8(jc.v)
        jc = jax_attn.KVCache(k=kq, v=vq, ks=ks, vs=vs)
        (kq, ks), (vq, vs) = attn._q8(c.k), attn._q8(c.v)
        c = attn.KVCache(k=kq, v=vq, ks=ks, vs=vs)
        for mine, ref in zip(c, jc):
            assert mine.numpy().tobytes() == np.asarray(ref).tobytes()
    before = [t.clone() for t in c if t is not None]
    kw = dict(num_heads=hq, num_kv_heads=hkv, head_dim=hd)
    for i in range(3):
        x = rng.standard_normal((2, 1, d)).astype(np.float32)
        idx = np.int32(12 + i)
        want, _ = jax_attn.attn_decode(jp, jnp.asarray(x), jc, jnp.asarray(
            idx), cross=True, use_rope=False, **kw)
        got, c = attn.attn_decode(p, torch.from_numpy(x), c,
                                  torch.tensor(idx), cross=True,
                                  use_rope=False, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for t, t0 in zip((t for t in c if t is not None), before):
        assert torch.equal(t, t0)          # nothing inserted


@pytest.mark.parametrize("arch,n", [("seamless-m4t-medium", 978_909_184),
                                    ("pixtral-12b", 12_798_284_800)])
def test_count_params_full_size(arch, n):
    assert count_params(get_config(arch)) == n
    assert count_params(get_config(arch), active_only=True) == n
