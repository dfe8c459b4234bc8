"""The port's RG-LRU hybrid (recurrentgemma) held against the JAX reference
on the CPU.

Inputs are made with numpy from a seed and handed to both frameworks.
Tolerances:

* the recurrence (the port's plain chunked version, which the CPU path
  runs, and its sequential oracle) against the reference's oracle and its
  XLA path: atol 2e-4, the reference's own kernel tests; the port's two
  plain versions against each other: atol 1e-5 + rtol 1e-5 (f32 sums in
  another order);
* the causal conv, the recurrent block and the tiny f32 model (prefill
  and decode logits, the cache), with ``lam`` moved where the decay
  matters: atol 1e-5 + rtol 1e-5 (logits 1e-4 over the ring's decode);
* bf16: see ``test_recurrent_apply_bf16_matches_reference``.

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
from repro.core.snapshot import leaf_names as jax_leaf_names  # noqa: E402
# repro.models first: its rglru_layer binds ``repro.kernels.rglru`` (the
# op) before the submodule of that name is imported below
from repro.models import count_params as jax_count_params  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import init_cache as jax_init_cache  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models import rglru_layer as jax_rglru_layer  # noqa: E402
from repro.models.transformer import abstract_params  # noqa: E402
from repro.models.transformer import forward as jax_forward  # noqa: E402
from repro.kernels.rglru import rglru as jax_rglru  # noqa: E402
from repro.kernels.rglru import rglru_ref as jax_rglru_ref  # noqa: E402
from repro.kernels.rglru.kernel import rglru_pallas  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import ICheckClient, ICheckCluster  # noqa: E402
from repro_torch.core.snapshot import snapshot_pytree  # noqa: E402
from repro_torch.kernels.rglru import (rglru, rglru_chunked,  # noqa: E402
                                       rglru_ref)
from repro_torch.models import (count_params, decode_step,  # noqa: E402
                                forward, init_cache, init_params, prefill)
from repro_torch.models import rglru_layer as rg  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.models.transformer import cast_params  # noqa: E402
from repro_torch.serve import ServeEngine, serve_max_len  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False

ARCH = "recurrentgemma-9b"
TOL = 2e-4                      # the recurrence: tests/test_kernels_rglru.py
MODEL = dict(atol=1e-5, rtol=1e-5)
B = 2


# --------------------------------------------------------------------------
# the recurrence
# --------------------------------------------------------------------------
def _mk(seed, b, t, d):
    """The inputs of ``tests/test_kernels_rglru.py``'s ``_mk``."""
    rng = np.random.default_rng(seed)
    la = -np.exp(rng.standard_normal((b, t, d))).astype(np.float32)
    g = rng.standard_normal((b, t, d)).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32)
    return la, g, h0


def _t(*arrays):
    return tuple(None if a is None else torch.from_numpy(a) for a in arrays)


def _close(got, want, atol, msg="", rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=msg)


SWEEP = [(2, 100, 256), (1, 64, 128), (1, 5, 512), (3, 33, 96)]


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("impl", ["xla", "ref"])
@pytest.mark.parametrize("b,t,d", SWEEP)
def test_plain_rglru_matches_reference(impl, b, t, d, with_h0):
    """The port's ``rglru`` on CPU tensors (the plain chunked version) and
    its sequential oracle against the reference's XLA path and oracle."""
    la, g, h0 = _mk(3, b, t, d)
    h0 = h0 if with_h0 else None
    if impl == "ref":
        wh, wT = jax_rglru_ref(jnp.asarray(la), jnp.asarray(g),
                               None if h0 is None else jnp.asarray(h0))
    else:
        wh, wT = jax_rglru(la, g, h0, impl=impl)
    # wait for the reference before the port runs: a first torch.exp in a
    # process, run while an XLA CPU computation is still in flight, has
    # returned one thread's block of values with relative errors up to
    # ~1e-4 (PERF.md, open questions)
    wh, wT = np.asarray(wh), np.asarray(wT)
    for fn in (rglru, rglru_ref):
        h, hT = fn(*_t(la, g, h0))
        assert h.dtype == torch.float32 and hT.dtype == torch.float32
        _close(h, wh, TOL, f"{fn.__name__} h")
        _close(hT, wT, TOL, f"{fn.__name__} h_final")


def test_chunk_lengths_agree():
    """Chunks of 8, 16 and 64 tokens and T not a multiple of any."""
    la, g, h0 = _mk(4, 2, 77, 64)
    want = rglru_ref(*_t(la, g, h0))
    for chunk in (8, 16, 64):
        got = rglru_chunked(*_t(la, g, h0), chunk=chunk)
        _close(got[0], want[0], 1e-5, f"h chunk {chunk}", rtol=1e-5)
        _close(got[1], want[1], 1e-5, f"h_final chunk {chunk}", rtol=1e-5)


def test_state_continuation():
    """[0, T/2) then [T/2, T) with the carried state == one shot, and
    T = 1 steps (decode) from the carried state continue it."""
    la, g, h0 = _mk(5, 2, 64, 128)
    h, hT = rglru(*_t(la, g, h0))
    h1, s1 = rglru(*_t(la[:, :32], g[:, :32], h0))
    h2, s2 = rglru(*_t(la[:, 32:], g[:, 32:]), s1)
    _close(torch.cat([h1, h2], 1), h, 1e-5, rtol=1e-5)
    _close(s2, hT, 1e-5, rtol=1e-5)
    st, outs = s1, []
    for t in range(32, 64):
        ht, st = rglru(*_t(la[:, t:t + 1], g[:, t:t + 1]), st)
        outs.append(ht)
    _close(torch.cat(outs, 1), h2, 1e-5, rtol=1e-5)
    _close(st, hT, 1e-5, rtol=1e-5)
    wh, wT = jax_rglru(la, g, h0, impl="xla")
    _close(h, wh, TOL)
    _close(hT, wT, TOL)


def test_initial_state_enters_in_f32():
    """bf16 g and a non-zero h0 (a decode step): the port takes h0 in f32,
    as ``rglru_ref`` and the reference's XLA path do, and agrees with them
    to f32 rounding.  ``rglru_pallas`` folds h0 into the first token in
    g's dtype (``kernel.py:68-71``), which rounds the carried state to
    bf16: its h_final is recorded here, about 7.7e-3 off (ROADMAP §3)."""
    rng = np.random.default_rng(14)
    b, t, d = 2, 1, 256
    la = -np.exp(rng.standard_normal((b, t, d))).astype(np.float32) * 0.1
    g = rng.standard_normal((b, t, d)).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32)
    gb = jnp.asarray(g).astype(jnp.bfloat16)
    want_h, want_T = jax_rglru_ref(jnp.asarray(la), gb, jnp.asarray(h0))
    xla_h, xla_T = jax_rglru(jnp.asarray(la), gb, jnp.asarray(h0),
                             impl="xla")
    got_h, got_T = rglru(torch.from_numpy(la),
                         torch.from_numpy(g).to(torch.bfloat16),
                         torch.from_numpy(h0))
    assert got_h.dtype == torch.bfloat16
    _close(got_T, want_T, 1e-6, "h_final vs rglru_ref")
    _close(got_T, xla_T, 1e-6, "h_final vs xla")
    # one bf16 rounding of f32 values an f32 ulp apart: a bf16 ulp apart
    _close(got_h.float(), np.asarray(want_h.astype(jnp.float32)), 0,
           "h", rtol=2 ** -7)
    _, pallas_T = rglru_pallas(jnp.asarray(la), gb, jnp.asarray(h0),
                               interpret=True)
    pallas_err = float(np.abs(np.asarray(pallas_T) -
                              np.asarray(want_T)).max())
    assert pallas_err > 1e-3, pallas_err       # the reference's bf16 fold


# --------------------------------------------------------------------------
# the recurrent block
# --------------------------------------------------------------------------
def _perturb(jparams, seed):
    """``lam`` moved from its init (where softplus(lam) ~ 4-9 makes
    a = exp(-8 softplus(lam) r) vanish, so the state forgets at once:
    ROADMAP §3) into [-6, 0], where the decay and a bf16 rounding of
    ``lam`` both show."""
    p = jax.tree.map(np.array, jparams)
    rng = np.random.default_rng(seed)

    def walk(tree):
        if isinstance(tree, dict):
            if "lam" in tree:
                tree["lam"] = rng.uniform(-6.0, 0.0, tree["lam"].shape) \
                    .astype(np.float32)
            for v in tree.values():
                walk(v)
    walk(p)
    return p


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, port cfg, jax params, port params on the CPU): tiny
    recurrentgemma in f32 (5 layers: (rec, rec, attn) + 2 rec tails,
    window 16) with ``lam`` perturbed."""
    jcfg = jax_get_config(ARCH, tiny=True)
    jparams, _ = jax_init_params(jcfg, jax.random.key(0))
    jparams = _perturb(jparams, 1)
    params = params_from_numpy(jparams, "cpu")
    return jcfg, get_config(ARCH, tiny=True), \
        jax.tree.map(jnp.asarray, jparams), params


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _flat(tree):
    """Leaf name -> host array, through the port's snapshot bridge."""
    return {name: r.parts[0]
            for name, r in snapshot_pytree(tree).regions.items()}


def _jax_flat(tree):
    return dict(zip(jax_leaf_names(tree), jax.tree_util.tree_leaves(tree)))


def _rec0(jparams, params):
    """Layer 0's recurrent block params (stack b0), both frameworks."""
    return (jax.tree.map(lambda x: x[0], jparams["stack"]["b0"]["rec"]),
            {k: v[0] for k, v in params["stack"]["b0"]["rec"].items()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_reference(pair, dtype):
    """f32 to 1e-5; bf16: the same products and sums in bf16 on both
    sides, which XLA may fuse in f32, so within 2 bf16 ulps (2^-7
    relative) plus 1e-2 absolute."""
    jcfg, cfg, jparams, params = pair
    jrec, rec = _rec0(jparams, params)
    rng = np.random.default_rng(10)
    n, w = cfg.resolved_rnn_width, cfg.conv1d_width
    y = rng.standard_normal((B, 9, n)).astype(np.float32)
    st = rng.standard_normal((B, w - 1, n)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_rglru_layer._causal_conv(jnp.asarray(y).astype(jd),
                                        jrec["conv_w"], jrec["conv_b"],
                                        jnp.asarray(st).astype(jd))
    got = rg._causal_conv(torch.from_numpy(y).to(td), rec["conv_w"],
                          rec["conv_b"], torch.from_numpy(st).to(td))
    tol = MODEL if dtype == "float32" else dict(atol=1e-2, rtol=2 ** -7)
    for name, g, wv in zip(("out", "state"), got, want):
        assert g.dtype == td, name
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(wv.astype(jnp.float32)),
                                   **tol, err_msg=name)


def _rec_inputs(cfg, seed, t):
    rng = np.random.default_rng(seed)
    n, w = cfg.resolved_rnn_width, cfg.conv1d_width
    x = rng.standard_normal((B, t, cfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((B, w - 1, n)).astype(np.float32)
    h = rng.standard_normal((B, n)).astype(np.float32)
    return x, conv, h


@pytest.mark.parametrize("t", [1, 12])
def test_recurrent_apply_matches_reference(pair, t):
    """From a non-zero carried state; T = 1 is a decode step."""
    jcfg, cfg, jparams, params = pair
    jrec, rec = _rec0(jparams, params)
    x, conv, h = _rec_inputs(cfg, 11 + t, t)
    want = jax_rglru_layer.recurrent_apply(
        jrec, jnp.asarray(x),
        jax_rglru_layer.RGLRUState(conv=jnp.asarray(conv),
                                   h=jnp.asarray(h)))
    got = rg.recurrent_apply(rec, torch.from_numpy(x),
                             rg.RGLRUState(*_t(conv, h)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **MODEL,
                               err_msg="out")
    for name in ("conv", "h"):
        np.testing.assert_allclose(getattr(got[1], name).numpy(),
                                   np.asarray(getattr(want[1], name)),
                                   **MODEL, err_msg=name)
    assert got[1].h.dtype == torch.float32


def test_recurrent_apply_bf16_matches_reference(pair):
    """bf16 activations with f32 ``w_ai`` and ``lam`` on both sides: the
    f32 gates, log_a and state agree; bf16 values round at other places
    (XLA fuses elementwise chains), so out within 5e-2 of its largest
    value (about 1), the f32 h within 2e-2 absolute."""
    jcfg, cfg, jparams, params = pair
    jrec, rec = _rec0(jparams, params)
    x, conv, h = _rec_inputs(cfg, 13, 12)
    want = jax_rglru_layer.recurrent_apply(
        jrec, jnp.asarray(x).astype(jnp.bfloat16),
        jax_rglru_layer.RGLRUState(
            conv=jnp.asarray(conv).astype(jnp.bfloat16), h=jnp.asarray(h)))
    served = cast_params({"rec": rec}, torch.bfloat16)["rec"]
    got = rg.recurrent_apply(
        served, torch.from_numpy(x).to(torch.bfloat16),
        rg.RGLRUState(conv=torch.from_numpy(conv).to(torch.bfloat16),
                      h=torch.from_numpy(h)))
    assert got[0].dtype == torch.bfloat16 and got[1].h.dtype == torch.float32
    assert got[1].conv.dtype == torch.bfloat16
    w0 = np.asarray(want[0].astype(jnp.float32))
    _close(got[0].float(), w0, 5e-2 * np.abs(w0).max(), "out")
    _close(got[1].h, np.asarray(want[1].h), 2e-2, "h")


# --------------------------------------------------------------------------
# the tiny model
# --------------------------------------------------------------------------
def test_param_tree_and_count_match_reference(pair):
    """Names and shapes equal the reference's abstract init; convert
    carries the hybrid tree (super-layers b0-b2 and tails) by name; the
    full model's count is the reference's."""
    jcfg, cfg, jparams, params = pair
    shapes, _ = abstract_params(jcfg)
    ref = _jax_flat(shapes)
    for tree in (init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
                 params):
        mine = _flat(tree)
        assert list(mine) == list(ref)
        for name in ref:
            assert tuple(mine[name].shape) == tuple(ref[name].shape), name
    assert "tail1/rec/w_ai" in ref and "stack/b2/attn/wkv" in ref
    for name, leaf in _jax_flat(jparams).items():
        assert _flat(params)[name].tobytes() == np.asarray(leaf).tobytes()
    full = get_config(ARCH)
    assert count_params(full) == jax_count_params(jax_get_config(ARCH)) \
        == 10_444_771_328


def test_forward_matches_reference(pair):
    jcfg, cfg, jparams, params = pair
    toks = _tokens(cfg, 20, (B, 40))
    want, _ = jax_forward(jcfg, jparams, {"tokens": toks})
    with torch.no_grad():
        got, aux = forward(cfg, params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-5)
    assert float(aux) == 0.0


def _check_cache(cache, jcache, cfg):
    mine, ref = _flat(cache), _jax_flat(jcache)
    assert list(mine) == list(ref)
    for name in ref:
        assert mine[name].shape == tuple(ref[name].shape), name
        np.testing.assert_allclose(mine[name], np.asarray(ref[name]),
                                   atol=1e-4, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("prompt", [10, 24, 40])
def test_prefill_and_ring_decode_match_reference(pair, prompt):
    """A prompt shorter than the window (16) and two longer ones (the
    prefill's ring roll), then 3 x window decode steps that wrap the ring:
    logits within 1e-4 at every step, the cache (ring slots and RG-LRU
    states) equal to the reference's, written in place, ring sizes
    unchanged, ``idx`` right."""
    jcfg, cfg, jparams, params = pair
    steps = 3 * cfg.window
    max_len = prompt + steps
    toks = _tokens(cfg, prompt, (B, prompt))
    jlogits, jcache = jax_prefill(jcfg, jparams, {"tokens": toks},
                                  jax_init_cache(jcfg, B, max_len))
    cache = init_cache(cfg, B, max_len, device="cpu")
    ring = cache["stack"]["b2"]["self"].k
    hs = cache["tails"][1].h
    assert ring.shape == (1, B, 1, cfg.window, cfg.resolved_head_dim)
    with torch.no_grad():
        logits, cache = prefill(cfg, params,
                                {"tokens": torch.from_numpy(toks)}, cache)
    assert cache["stack"]["b2"]["self"].k is ring     # written in place
    assert cache["tails"][1].h is hs
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-5)
    _check_cache(cache, jcache, cfg)
    assert int(cache["idx"]) == prompt
    step_toks = _tokens(cfg, 100 + prompt, (steps, B, 1))
    jstep = jax.jit(jax_decode_step, static_argnums=0)
    for i in range(steps):
        jlogits, jcache = jstep(jcfg, jparams, jcache, step_toks[i])
        with torch.no_grad():
            logits, cache = decode_step(cfg, params, cache,
                                        torch.from_numpy(step_toks[i]))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=1e-4, rtol=1e-5,
                                   err_msg=f"decode step {i}")
    _check_cache(cache, jcache, cfg)
    assert cache["stack"]["b2"]["self"].k is ring
    assert ring.shape == (1, B, 1, cfg.window, cfg.resolved_head_dim)
    assert int(cache["idx"]) == prompt + steps


def test_generate_matches_reference_tokens(pair):
    jcfg, cfg, jparams, params = pair
    toks = _tokens(cfg, 12, (B, 20))
    max_len = serve_max_len(cfg, 20, 8)
    want = JaxServeEngine(jcfg, jparams, max_len=max_len).generate(
        {"tokens": toks}, gen_len=8)
    got = ServeEngine(cfg, params, max_len=max_len, device="cpu").generate(
        {"tokens": toks}, gen_len=8)
    np.testing.assert_array_equal(got, want)


def _bf16(cfg):
    return dataclasses.replace(cfg, dtype="bfloat16")


def test_bf16_cast_keeps_the_reference_f32_leaves(pair):
    """The weights a bf16 engine serves with, evaluated in f32, against the
    reference in f32 on its weights rounded to bf16 where it rounds them
    (every matrix, the conv and its bias) and kept where it uses them in
    f32 (norm scales, ``w_ai``, ``lam``): prefill logits and cache agree
    as in f32, so a cast of ``w_ai`` or the perturbed ``lam`` to bf16
    (2^-9 relative) shows."""
    jcfg, cfg, jparams, params = pair
    eng = ServeEngine(_bf16(cfg), params, max_len=24, device="cpu")
    keep = ("scale",) + rg.F32_LEAVES
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        name = path[-1].key
        got = eng.params
        for p in path:
            got = got[p.key]
        assert got.dtype == (torch.float32 if name in keep
                             else torch.bfloat16), name

    def rounded(path, x):
        if path[-1].key in keep:
            return x
        return x.astype(jnp.bfloat16).astype(jnp.float32)

    jrounded = jax.tree_util.tree_map_with_path(rounded, jparams)
    toks = _tokens(cfg, 5, (B, 24))
    jlogits, jcache = jax_prefill(jcfg, jrounded, {"tokens": toks},
                                  jax_init_cache(jcfg, B, 24))

    def f32(tree):
        if isinstance(tree, dict):
            return {k: f32(v) for k, v in tree.items()}
        return tree.float()

    with torch.no_grad():
        logits, cache = prefill(cfg, f32(eng.params),
                                {"tokens": torch.from_numpy(toks)},
                                init_cache(cfg, B, 24, device="cpu"))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(cache["stack"]["b0"].h.numpy(),
                               np.asarray(jcache["stack"]["b0"].h), **MODEL)


# --------------------------------------------------------------------------
# serving-state checkpointing
# --------------------------------------------------------------------------
def test_serving_state_checkpoint(pair):
    """Commit after prefill (prompt longer than the window: the rolled
    ring), restore from the agents: the restored cache is bit-equal to a
    second prefill's, keeps the hybrid layout, and decoding from it gives
    the live run's tokens across the ring's wrap."""
    _, cfg, _, params = pair
    batch = {"tokens": _tokens(cfg, 6, (B, 20))}
    with ICheckCluster(n_icheck_nodes=1) as cluster:
        client = ICheckClient("serve", cluster.controller).init()
        eng = ServeEngine(cfg, params, max_len=serve_max_len(cfg, 20, 12),
                          device="cpu")
        out = eng.generate(batch, gen_len=12, checkpoint_client=client)
        eng.last_commit.wait(timeout=60)
        restored = eng.restore_serving_state(client, batch_size=B)
        _, fresh = eng.prefill(batch)
        mine, want = _flat(restored), _flat(fresh)
        assert list(mine) == list(want)
        for name in want:
            assert mine[name].dtype == want[name].dtype
            assert mine[name].tobytes() == want[name].tobytes(), name
        assert isinstance(restored["stack"]["b0"], rg.RGLRUState)
        assert isinstance(restored["stack"]["b2"]["self"], KVCache)
        assert isinstance(restored["tails"][0], rg.RGLRUState)
        cont = eng.decode_greedy(restored, out[:, :1], 11)
        np.testing.assert_array_equal(cont, out[:, 1:])
        client.finalize()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_snapshot_regions_match_reference(dtype):
    """The same hybrid cache, snapshot by JAX and by the port: the same
    region names, shapes and bytes (bf16 leaves as their uint16 bits)."""
    jcfg = dataclasses.replace(jax_get_config(ARCH, tiny=True), dtype=dtype)
    jparams, _ = jax_init_params(jcfg, jax.random.key(0))
    _, jcache = jax_prefill(jcfg, jparams,
                            {"tokens": _tokens(jcfg, 7, (2, 20))},
                            jax_init_cache(jcfg, 2, 24))

    def to_port(x):
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(a))

    def rec(st):
        return rg.RGLRUState(*(to_port(x) for x in st))

    def kv(d):
        return {"self": KVCache(k=to_port(d["self"].k),
                                v=to_port(d["self"].v))}

    js = jcache["stack"]
    cache = {"stack": {"b0": rec(js["b0"]), "b1": rec(js["b1"]),
                       "b2": kv(js["b2"])},
             "tails": [rec(st) for st in jcache["tails"]],
             "idx": to_port(jcache["idx"])}
    want = jax_snapshot_pytree(jcache)
    got = snapshot_pytree(cache)
    assert list(got.regions) == list(want.regions)
    assert "tails/1/h" in got.regions and "stack/b2/self/k" in got.regions
    for name, w in want.regions.items():
        g = got.regions[name]
        assert g.meta.shape == w.meta.shape and g.boxes == w.boxes
        assert g.meta.nbytes == w.meta.nbytes
        want_dtype = "uint16" if w.meta.dtype == "bfloat16" else w.meta.dtype
        assert g.meta.dtype == want_dtype
        assert g.parts[0].tobytes() == np.asarray(w.parts[0]).tobytes()
    mine = init_cache(get_config(ARCH, tiny=True), 2, 24, device="cpu")
    assert list(snapshot_pytree(mine).regions) == list(want.regions)


def test_serve_cli_recurrentgemma_on_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", ARCH, "--batch", "2", "--prompt-len", "20", "--gen",
          "4", "--icheck", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "generated (2, 4)" in out and "first sequence:" in out
