"""The port's int8 KV cache held against the JAX reference on the CPU.

* ``_q8`` gives codes and f16 scales bit-equal to the reference's under
  ``jax.jit``, the way the reference serves (its scale ``absmax / 127.0``
  is a multiply by the f32 reciprocal there; ROADMAP.md section 3), and
  ``_dq`` is bit-equal to the reference's;
* tiny models (seamless-m4t-medium's int8 self and cross caches among
  them), the reference's weights carried across by name
  (``params_from_numpy``): the port's int8 decode against its own exact
  cache, argmax-equal and within 0.1 (the twin of
  ``tests/test_kv_quant.py``); the port's int8 prefill and decode logits
  against the reference's jitted int8 path within ``Q8_ATOL``, with at
  most ``Q8_SHARE`` of the cache's codes and scales differing.  f32 sums
  in another order can put a value on the other side of a rounding edge:
  a scale then moves by one f16 ulp (2^-11 of it) or a code by one step.
  One such scale moved tiny deepseek-7b's logits by 5.0e-5; ``Q8_ATOL`` is
  four times that;
* the ring of a sliding-window layer rolled past its window, the cache's
  size, its snapshot regions, a serving commit and restore, and its
  leaves' storage.

f32 matmuls run in full precision (``allow_tf32 = False``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import snapshot_pytree as jax_snapshot_pytree  # noqa: E402
# repro.models first: its rglru_layer binds ``repro.kernels.rglru`` (the
# op) before anything imports the submodule of that name
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import init_cache as jax_init_cache  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import ICheckClient, ICheckCluster  # noqa: E402
from repro_torch.core.snapshot import _flatten, snapshot_pytree  # noqa: E402
from repro_torch.models import (decode_step, init_cache,  # noqa: E402
                                prefill)
from repro_torch.models.attention import (_dq, _q8, _q8_block,  # noqa: E402
                                          init_kv_cache)
from repro_torch.serve import ServeEngine, serve_max_len  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False

Q8_ATOL = 2e-4
Q8_SHARE = 1e-3
B = 2
_jit_q8 = jax.jit(jax_attention._q8)


def _bits(a):
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _frames(cfg, seed, b):
    """The encoder-decoder's audio frames (an empty dict for a model
    without them), numpy."""
    if cfg.frontend != "frames":
        return {}
    return {"frames": np.random.default_rng(seed).standard_normal(
        (b, cfg.num_frames, cfg.d_model)).astype(np.float32)}


def _pair(arch, quant=True, **over):
    """(jax cfg, port cfg, jax params, port params) for a tiny arch."""
    jcfg = dataclasses.replace(jax_get_config(arch, tiny=True),
                               kv_quant=quant, **over)
    cfg = dataclasses.replace(get_config(arch, tiny=True), kv_quant=quant,
                              **over)
    jparams, _ = jax_init_params(jcfg, jax.random.key(0))
    return jcfg, cfg, jparams, params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")


# --------------------------------------------------------------------------
# the codec
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(2, 4, 64, 16), (2, 4, 64, 128),
                                   (1, 2, 33, 256), (3, 5, 6), (2, 7, 10),
                                   (1 << 18, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q8_bit_equal_to_jitted_reference(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    x *= np.exp(rng.uniform(-8, 8, shape[:-1] + (1,))).astype(np.float32)
    x[..., :min(4, shape[-1])] = 0.0        # a zero block: scale 1
    x[0, 0] = 0.0                           # a zero row
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    assert np.array_equal(_bits(jx.astype(jnp.float32)),
                          _bits(tx.float().numpy()))
    want_q, want_s = _jit_q8(jx)
    got_q, got_s = _q8(tx)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float16
    blk = _q8_block(shape[-1])
    assert got_s.shape == (*shape[:-1], shape[-1] // blk)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(_bits(got_s.numpy()), _bits(want_s))
    zero = tx.float().reshape(*shape[:-1], -1, blk).abs().amax(-1) == 0
    assert zero.any() and bool((got_s[zero] == 1.0).all())
    for dq in (jax_attention._dq, jax.jit(jax_attention._dq)):
        want = dq(want_q, want_s)
        np.testing.assert_array_equal(_bits(_dq(got_q, got_s).numpy()),
                                      _bits(want))


def test_q8_rounds_half_to_even_and_clips():
    # a block [127, 0.5 s, 1.5 s, 2.5 s] has scale 1: codes 127, 0, 2, 2
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5], [-127.0, -0.5, -1.5, -2.5]])
    q, s = _q8(x)
    assert q.tolist() == [[127, 0, 2, 2], [-127, 0, -2, -2]]
    assert s.tolist() == [[1.0], [1.0]]
    want_q, _ = _jit_q8(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))


# --------------------------------------------------------------------------
# the cache on the serving path
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["deepseek-7b", "yi-6b",
                                  "recurrentgemma-9b", "seamless-m4t-medium"])
def test_int8_kv_matches_exact(arch):
    """The twin of ``tests/test_kv_quant.py::test_int8_kv_matches_exact``:
    4 greedy decode steps from an int8 cache against the exact cache (the
    encoder-decoder's int8 self and cross caches)."""
    _, cfg, _, params = _pair(arch, quant=False)
    cfgq = dataclasses.replace(cfg, kv_quant=True)
    batch = {"tokens": _tokens(cfg, 1, (B, 16)), **_frames(cfg, 2, B)}
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = {}
    for c in (cfg, cfgq):
        cache = init_cache(c, B, 32, device="cpu")
        with torch.no_grad():
            lg, cache = prefill(c, params, batch, cache)
            nxt = torch.argmax(lg, -1)[:, None].to(torch.int32)
            out = []
            for _ in range(4):
                lg, cache = decode_step(c, params, cache, nxt)
                nxt = torch.argmax(lg, -1)[:, None].to(torch.int32)
                out.append(lg.numpy())
        logits[c.kv_quant] = np.stack(out)
    err = np.max(np.abs(logits[True] - logits[False]))
    assert err < 0.1, err
    np.testing.assert_array_equal(logits[True].argmax(-1),
                                  logits[False].argmax(-1))


def _jax_leaves(tree):
    from repro.core.snapshot import leaf_names
    return dict(zip(leaf_names(tree), jax.tree_util.tree_leaves(tree)))


def _port_leaves(tree):
    return {"/".join(p): t for p, t in _flatten(tree)}


def _differing(mine, ref):
    """Leaf name -> (elements of the int8 cache that differ, elements)."""
    out = {}
    for name, want in ref.items():
        got = mine[name].numpy()
        want = np.asarray(want)
        if got.dtype in (np.int8, np.float16):
            out[name] = (int((_bits(got) != _bits(want)).sum()), got.size)
    return out


@pytest.mark.parametrize("arch,prompt,steps", [
    ("deepseek-7b", 16, 6), ("yi-6b", 16, 6), ("phi3-medium-14b", 16, 6),
    # the window of 16: the prompt rolls the ring, the steps wrap it
    ("recurrentgemma-9b", 40, 20),
    # int8 self and cross caches
    ("seamless-m4t-medium", 16, 6)])
def test_int8_path_matches_jitted_reference(arch, prompt, steps):
    jcfg, cfg, jparams, params = _pair(arch)
    batch = {"tokens": _tokens(cfg, 1, (B, prompt)), **_frames(cfg, 2, B)}
    max_len = prompt + steps
    jlg, jcache = jax.jit(lambda p, b, c: jax_prefill(jcfg, p, b, c))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()},
        jax_init_cache(jcfg, B, max_len))
    cache = init_cache(cfg, B, max_len, device="cpu")
    with torch.no_grad():
        lg, cache = prefill(cfg, params, {k: torch.from_numpy(v)
                                          for k, v in batch.items()}, cache)
    errs = [np.abs(lg.numpy() - np.asarray(jlg)).max()]
    shares = [_differing(_port_leaves(cache), _jax_leaves(jcache))]
    jdec = jax.jit(lambda p, c, t: jax_decode_step(jcfg, p, c, t))
    for i in range(steps):
        nxt = np.asarray(jnp.argmax(jlg, -1))[:, None].astype(np.int32)
        jlg, jcache = jdec(jparams, jcache, jnp.asarray(nxt))
        with torch.no_grad():
            lg, cache = decode_step(cfg, params, cache,
                                    torch.from_numpy(nxt))
        errs.append(np.abs(lg.numpy() - np.asarray(jlg)).max())
    shares.append(_differing(_port_leaves(cache), _jax_leaves(jcache)))
    assert any(k.endswith("/ks") for k in shares[0])
    if cfg.is_encdec:
        assert shares[0]["stack/b0/cross/ks"][1] > 0
    bad = sum(n for s in shares for n, _ in s.values())
    total = sum(m for s in shares for _, m in s.values())
    print(f"{arch}: logits max abs err {max(errs):.2e}; {bad} of {total} "
          f"cache codes and scales differ")
    assert bad <= Q8_SHARE * total, shares
    assert max(errs) <= Q8_ATOL, errs


def test_ring_rolls_codes_and_scales_alike():
    """recurrentgemma's windowed layers with a 40-token prompt over 16
    slots: the int8 ring holds ``_q8`` of the exact ring, codes and scales
    rolled together (prefill's K and V do not depend on the cache)."""
    _, cfg, _, params = _pair("recurrentgemma-9b", quant=False)
    cfgq = dataclasses.replace(cfg, kv_quant=True)
    toks = torch.from_numpy(_tokens(cfg, 2, (B, 40)))
    caches = {}
    for c in (cfg, cfgq):
        with torch.no_grad():
            _, caches[c.kv_quant] = prefill(
                c, params, {"tokens": toks},
                init_cache(c, B, 48, device="cpu"))
    exact, q8 = caches[False]["stack"]["b2"]["self"], \
        caches[True]["stack"]["b2"]["self"]
    assert q8.k.shape[-2] == cfg.window == 16
    for buf, sbuf, want in ((q8.k, q8.ks, exact.k), (q8.v, q8.vs, exact.v)):
        codes, scales = _q8(want)
        assert torch.equal(buf, codes)
        assert torch.equal(sbuf, scales)
    # slot p % 16 holds position p: the newest position, 39, is in slot 7
    codes, scales = _q8(exact.k[..., 7, :])
    assert torch.equal(q8.k[..., 7, :], codes)


def test_int8_cache_is_smaller():
    """The twin of ``tests/test_kv_quant.py::test_int8_cache_is_smaller``."""
    cfg = get_config("deepseek-7b", tiny=True)
    cfgq = dataclasses.replace(cfg, kv_quant=True)

    def nbytes(c):
        return sum(t.numel() * t.element_size()
                   for _, t in _flatten(init_cache(c, 4, 256, device="cpu")))
    assert nbytes(cfgq) < 0.45 * nbytes(cfg)


@pytest.mark.parametrize("arch", ["deepseek-7b", "recurrentgemma-9b",
                                  "seamless-m4t-medium"])
def test_snapshot_regions_match_reference(arch):
    """A fresh int8 cache, snapshot by both: the same region names,
    shapes, dtypes (int8 codes, float16 scales) and bytes."""
    jcfg, cfg, _, _ = _pair(arch)
    ref = jax_snapshot_pytree(jax_init_cache(jcfg, B, 24)).regions
    mine = snapshot_pytree(init_cache(cfg, B, 24, device="cpu")).regions
    assert list(mine) == list(ref)
    assert any(r.meta.dtype == "int8" for r in mine.values())
    assert any(r.meta.dtype == "float16" for r in mine.values())
    for name, r in ref.items():
        assert mine[name].meta.shape == r.meta.shape, name
        assert mine[name].meta.dtype == r.meta.dtype, name
        assert mine[name].meta.nbytes == r.meta.nbytes, name
        want = np.concatenate([np.asarray(p).reshape(-1)
                               for p in r.parts.values()])
        got = mine[name].parts[0].reshape(-1)
        assert _bits(got).tobytes() == _bits(want).tobytes(), name


def test_serving_commit_and_restore_bit_equal():
    cfg = dataclasses.replace(get_config("deepseek-7b", tiny=True),
                              kv_quant=True)
    _, _, _, params = _pair("deepseek-7b")
    batch = {"tokens": _tokens(cfg, 5, (B, 12))}
    with ICheckCluster(n_icheck_nodes=1) as cluster:
        client = ICheckClient("serve", cluster.controller).init()
        eng = ServeEngine(cfg, params, max_len=serve_max_len(cfg, 12, 6),
                          device="cpu")
        out = eng.generate(batch, gen_len=6, checkpoint_client=client)
        eng.last_commit.wait(timeout=60)
        restored = eng.restore_serving_state(client, batch_size=B)
        _, fresh = eng.prefill(batch)
        got, want = list(_flatten(restored)), list(_flatten(fresh))
        assert [p for p, _ in got] == [p for p, _ in want]
        dtypes = {t.dtype for _, t in got}
        assert {torch.int8, torch.float16} <= dtypes
        for (path, g), (_, w) in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), path
        cont = eng.decode_greedy(restored, out[:, :1], 5)
        np.testing.assert_array_equal(cont, out[:, 1:])
        client.finalize()


def test_serving_commit_and_restore_bit_equal_encdec():
    """Tiny seamless-m4t-medium's int8 self and cross caches through a
    serving commit and restore: bit-equal to a second prefill's, and
    decoding from them gives the live run's tokens."""
    cfg = dataclasses.replace(get_config("seamless-m4t-medium", tiny=True),
                              kv_quant=True)
    _, _, _, params = _pair("seamless-m4t-medium")
    batch = {"tokens": _tokens(cfg, 5, (B, 12)), **_frames(cfg, 6, B)}
    with ICheckCluster(n_icheck_nodes=1) as cluster:
        client = ICheckClient("serve", cluster.controller).init()
        eng = ServeEngine(cfg, params, max_len=serve_max_len(cfg, 12, 6),
                          device="cpu")
        out = eng.generate(batch, gen_len=6, checkpoint_client=client)
        eng.last_commit.wait(timeout=60)
        restored = eng.restore_serving_state(client, batch_size=B)
        _, fresh = eng.prefill(batch)
        got, want = list(_flatten(restored)), list(_flatten(fresh))
        assert [p for p, _ in got] == [p for p, _ in want]
        assert ("stack", "b0", "cross", "ks") in [p for p, _ in got]
        for (path, g), (_, w) in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), path
        cont = eng.decode_greedy(restored, out[:, :1], 5)
        np.testing.assert_array_equal(cont, out[:, 1:])
        client.finalize()


def test_fresh_int8_cache_leaves_are_distinct():
    """The cache is written in place, so k and v (and ks and vs) must not
    share storage as the reference's one array each does."""
    cache = init_kv_cache(2, 3, 8, 16, torch.float32, quant=True,
                          lead=(2,), device="cpu")
    ptrs = {f: getattr(cache, f).untyped_storage().data_ptr()
            for f in ("k", "v", "ks", "vs")}
    assert len(set(ptrs.values())) == 4, ptrs
    cache.k.fill_(3)
    cache.ks.fill_(2)
    assert int(cache.v.abs().sum()) == 0
    assert bool((cache.vs == 1).all())
    assert cache.ks.shape == (2, 2, 3, 8, 4)
    assert cache.k.dtype == torch.int8 and cache.ks.dtype == torch.float16
