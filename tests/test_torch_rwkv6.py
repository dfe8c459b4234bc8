"""The port's RWKV-6 path held against the JAX reference on the CPU.

Inputs are made with numpy from a seed and handed to both frameworks.
Tolerances:

* the recurrence (the port's plain chunked version, which the CPU path
  runs, and its sequential oracle) against the reference's Pallas kernel
  in interpret mode, its chunked XLA path and its oracle: atol 1e-4 +
  rtol 1e-4 for the same algorithm in f32 (sums in another order), atol
  2e-3 across algorithms, as ``tests/test_kernels_rwkv6.py`` allows;
* layers and the tiny f32 model (prefill and decode logits, the
  recurrent state), with ``w0``, ``u``, ``gn_scale`` and ``gn_bias``
  perturbed from their init values: atol 1e-5 + rtol 1e-5;
* the tiny model in bf16: see ``test_bf16_serving_matches_reference``.

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
# repro.models first: its rwkv6_layer binds ``repro.kernels.rwkv6`` (the
# op) before the submodule of that name is imported below
from repro.models import count_params as jax_count_params  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import init_cache as jax_init_cache  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models import rwkv6_layer as jax_rwkv  # noqa: E402
from repro.models.layers import groupnorm_heads as jax_groupnorm  # noqa: E402
from repro.kernels.rwkv6 import rwkv6 as jax_rwkv6  # noqa: E402
from repro.kernels.rwkv6 import rwkv6_ref as jax_rwkv6_ref  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import ICheckClient, ICheckCluster  # noqa: E402
from repro_torch.core.snapshot import snapshot_pytree  # noqa: E402
from repro_torch.kernels.rwkv6 import (LOG_W_MIN, rwkv6,  # noqa: E402
                                       rwkv6_chunked, rwkv6_ref)
from repro_torch.models import (count_params, decode_step,  # noqa: E402
                                init_cache, init_params, prefill)
from repro_torch.models import rwkv6_layer as rwkv  # noqa: E402
from repro_torch.models.layers import groupnorm_heads  # noqa: E402
from repro_torch.serve import ServeEngine, serve_max_len  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False

ARCH = "rwkv6-7b"
SAME, ACROSS = 1e-4, 2e-3       # recurrence: same algorithm / across
MODEL = dict(atol=1e-5, rtol=1e-5)
B, T, GEN = 2, 12, 4


# --------------------------------------------------------------------------
# the recurrence
# --------------------------------------------------------------------------
def _mk(seed, b, h, t, d, decay_scale=1.0):
    """The inputs of ``tests/test_kernels_rwkv6.py``'s ``_mk``."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((b, h, t, d)).astype(np.float32) * 0.5
    k = rng.standard_normal((b, h, t, d)).astype(np.float32) * 0.5
    v = rng.standard_normal((b, h, t, d)).astype(np.float32) * 0.5
    lw = -np.exp(rng.standard_normal((b, h, t, d))).astype(np.float32) \
        * decay_scale
    u = rng.standard_normal((h, d)).astype(np.float32) * 0.5
    s0 = rng.standard_normal((b, h, d, d)).astype(np.float32) * 0.1
    return r, k, v, lw, u, s0


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _close(got, want, atol, msg=""):
    """atol, and rtol 1e-4 where atol is the same-algorithm one."""
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=SAME if atol == SAME else 0,
                               err_msg=msg)


SHAPES = [(2, 3, 130, 64, 64),     # unaligned T (padding path)
          (1, 2, 64, 32, 16),
          (1, 1, 7, 16, 64)]       # T < chunk


@pytest.mark.parametrize("impl", ["interpret", "xla", "ref"])
@pytest.mark.parametrize("b,h,t,d,chunk", SHAPES)
def test_plain_rwkv6_matches_reference(impl, b, h, t, d, chunk):
    """The port's ``rwkv6`` on CPU tensors (the plain chunked version)
    against each of the reference's implementations."""
    inputs = _mk(3, b, h, t, d)
    o, sT = rwkv6(*_t(*inputs), chunk=chunk)
    wo, ws = jax_rwkv6(*inputs, chunk=chunk, impl=impl)
    tol = ACROSS if impl == "ref" else SAME
    _close(o, wo, tol, "o")
    _close(sT, ws, tol, "sT")
    assert o.dtype == torch.float32 and sT.dtype == torch.float32


@pytest.mark.parametrize("b,h,t,d,chunk", SHAPES)
def test_sequential_oracle_matches_reference(b, h, t, d, chunk):
    inputs = _mk(4, b, h, t, d)
    o, sT = rwkv6_ref(*_t(*inputs))
    wo, ws = jax_rwkv6_ref(*map(jnp.asarray, inputs))
    _close(o, wo, SAME, "o")
    _close(sT, ws, SAME, "sT")


@pytest.mark.parametrize("impl", ["interpret", "xla"])
def test_single_token_with_carried_state(impl):
    """Decode runs the recurrence at T = 1 from the carried state: the
    result equals the reference's and continues a run over T tokens to
    the one-shot run over T + 1."""
    r, k, v, lw, u, s0 = _mk(5, 2, 3, 9, 32)
    o8, s8 = rwkv6(*_t(r[:, :, :8], k[:, :, :8], v[:, :, :8],
                       lw[:, :, :8], u, s0))
    one = (r[:, :, 8:], k[:, :, 8:], v[:, :, 8:], lw[:, :, 8:])
    o1, s9 = rwkv6(*_t(*one, u), s8)
    wo, ws = jax_rwkv6(*one, u, s8.numpy(), impl=impl)
    _close(o1, wo, SAME, "o")
    _close(s9, ws, SAME, "sT")
    o_all, s_all = rwkv6(*_t(r, k, v, lw, u, s0))
    _close(torch.cat([o8, o1], dim=2), o_all, SAME, "o one-shot")
    _close(s9, s_all, SAME, "sT one-shot")


@pytest.mark.parametrize("decay_scale", [10.0, 100.0])
def test_extreme_decay_clamped_like_the_kernel(decay_scale):
    """log_w far below LOG_W_MIN: the port clamps as the Pallas kernel
    does (equal to it in interpret mode), stays finite, and agrees with
    the unclamped oracle, since exp(-30) is numerically zero."""
    inputs = _mk(6, 1, 2, 96, 32, decay_scale=decay_scale)
    assert (inputs[3] < LOG_W_MIN).any()
    o, sT = rwkv6(*_t(*inputs), chunk=32)
    assert torch.isfinite(o).all() and torch.isfinite(sT).all()
    wo, ws = jax_rwkv6(*inputs, chunk=32, impl="interpret")
    _close(o, wo, SAME, "o vs interpret")
    _close(sT, ws, SAME, "sT vs interpret")
    ro, rs = jax_rwkv6_ref(*map(jnp.asarray, inputs))
    _close(o, ro, ACROSS, "o vs ref")
    _close(sT, rs, ACROSS, "sT vs ref")


def test_state_continuation():
    """[0, T/2) then [T/2, T) with the carried state == one shot."""
    r, k, v, lw, u, s0 = _mk(7, 1, 2, 64, 32)
    o_full, s_full = rwkv6(*_t(r, k, v, lw, u, s0), chunk=16)
    half = 32
    o1, s1 = rwkv6(*_t(r[:, :, :half], k[:, :, :half], v[:, :, :half],
                       lw[:, :, :half], u, s0), chunk=16)
    o2, s2 = rwkv6(*_t(r[:, :, half:], k[:, :, half:], v[:, :, half:],
                       lw[:, :, half:], u), s1, chunk=16)
    _close(o1, o_full[:, :, :half], SAME)
    _close(o2, o_full[:, :, half:], SAME)
    _close(s2, s_full, SAME)
    wo, ws = jax_rwkv6(r, k, v, lw, u, s0, chunk=16, impl="xla")
    _close(o_full, wo, SAME)
    _close(s_full, ws, SAME)


def test_chunked_matches_sequential_in_bf16_inputs():
    """bf16 r/k/v: both plain versions compute in f32 and return o in
    v.dtype (one bf16 rounding apart at most)."""
    r, k, v, lw, u, s0 = _mk(8, 2, 2, 40, 16)
    rb, kb, vb = (torch.from_numpy(x).to(torch.bfloat16) for x in (r, k, v))
    o, sT = rwkv6(rb, kb, vb, *_t(lw, u, s0))
    ro, rs = rwkv6_ref(rb, kb, vb, *_t(lw, u, s0))
    assert o.dtype == torch.bfloat16 and sT.dtype == torch.float32
    torch.testing.assert_close(o.float(), ro.float(), atol=SAME,
                               rtol=2 ** -7)
    torch.testing.assert_close(sT, rs, atol=SAME, rtol=0)
    assert torch.equal(rwkv6_chunked(rb, kb, vb, *_t(lw, u, s0))[0], o)


# --------------------------------------------------------------------------
# layers and the tiny model
# --------------------------------------------------------------------------
def _perturb(jparams, seed):
    """The f32-used leaves moved off their init values (-4, 0, 1, 0),
    which bf16 represents exactly, to values it does not."""
    p = jax.tree.map(np.array, jparams)
    rng = np.random.default_rng(seed)
    tm = p["stack"]["b0"]["tm"]
    tm["w0"] = rng.uniform(-3.0, 0.5, tm["w0"].shape).astype(np.float32)
    tm["u"] = (rng.standard_normal(tm["u"].shape) * 0.5).astype(np.float32)
    tm["gn_scale"] = (1 + rng.standard_normal(tm["gn_scale"].shape)
                      * 0.3).astype(np.float32)
    tm["gn_bias"] = (rng.standard_normal(tm["gn_bias"].shape)
                     * 0.3).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, port cfg, jax params, port params on the CPU): tiny
    rwkv6-7b in f32 with the f32-used leaves perturbed."""
    jcfg = jax_get_config(ARCH, tiny=True)
    jparams, _ = jax_init_params(jcfg, jax.random.key(0))
    jparams = _perturb(jparams, 1)
    params = params_from_numpy(jparams, "cpu")
    return jcfg, get_config(ARCH, tiny=True), \
        jax.tree.map(jnp.asarray, jparams), params


def _layer0(tree):
    return jax.tree.map(lambda x: x[0], tree)


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _flat(tree):
    """Leaf name -> host array, through the port's snapshot bridge."""
    return {name: r.parts[0]
            for name, r in snapshot_pytree(tree).regions.items()}


def _jax_flat(tree):
    return dict(zip(jax_leaf_names(tree), jax.tree_util.tree_leaves(tree)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_groupnorm_heads_matches_reference(dtype):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32) * 3 + 1
    scale = (1 + rng.standard_normal((4, 16)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal((4, 16)) * 0.3).astype(np.float32)
    want = jax_groupnorm(jnp.asarray(x).astype(dtype), jnp.asarray(scale),
                         jnp.asarray(bias))
    got = groupnorm_heads(torch.from_numpy(x).to(getattr(torch, dtype)),
                          torch.from_numpy(scale), torch.from_numpy(bias))
    assert str(got.dtype) == f"torch.{dtype}"
    # bf16: f32 statistics on both sides, then one rounding to bf16
    rtol = 1e-6 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=1e-6, rtol=rtol)


def test_timemix_matches_reference(pair):
    jcfg, cfg, jparams, params = pair
    rng = np.random.default_rng(10)
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    last = rng.standard_normal((B, d)).astype(np.float32)
    wkv = (rng.standard_normal((B, d // hd, hd, hd)) * 0.1).astype(
        np.float32)
    want = jax_rwkv.timemix_apply(_layer0(jparams["stack"]["b0"]["tm"]),
                                  jnp.asarray(x), jnp.asarray(last),
                                  jnp.asarray(wkv), hd)
    tm = {k: v[0] for k, v in params["stack"]["b0"]["tm"].items()}
    got = rwkv.timemix_apply(tm, *_t(x, last, wkv), hd)
    for name, g, w in zip(("out", "last", "wkv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MODEL,
                                   err_msg=name)


def test_chanmix_matches_reference(pair):
    jcfg, cfg, jparams, params = pair
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    last = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
    want = jax_rwkv.chanmix_apply(_layer0(jparams["stack"]["b0"]["cm"]),
                                  jnp.asarray(x), jnp.asarray(last))
    cm = {k: v[0] for k, v in params["stack"]["b0"]["cm"].items()}
    got = rwkv.chanmix_apply(cm, *_t(x, last))
    for name, g, w in zip(("out", "last"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MODEL,
                                   err_msg=name)


def test_param_tree_and_count_match_reference(pair):
    jcfg, cfg, jparams, _ = pair
    mine = _flat(init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    ref = _jax_flat(jparams)
    assert list(mine) == list(ref)
    for name in ref:
        assert tuple(mine[name].shape) == tuple(ref[name].shape), name
    full = get_config(ARCH)
    assert count_params(full) == jax_count_params(jax_get_config(ARCH)) \
        == 7_551_455_232


def test_prefill_and_decode_match_reference(pair):
    """Prefill logits and state, then each decode step's logits and the
    state after them; the state is written into the cache in place."""
    jcfg, cfg, jparams, params = pair
    toks = _tokens(cfg, 2, (B, T))
    jlogits, jcache = jax_prefill(jcfg, jparams, {"tokens": toks},
                                  jax_init_cache(jcfg, B, T + GEN))
    cache = init_cache(cfg, B, T + GEN, device="cpu")
    wkv = cache["stack"]["b0"].wkv
    with torch.no_grad():
        logits, cache = prefill(cfg, params,
                                {"tokens": torch.from_numpy(toks)}, cache)
    assert cache["stack"]["b0"].wkv is wkv          # written in place
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL)

    def check_state():
        mine, ref = _flat(cache), _jax_flat(jcache)
        assert list(mine) == list(ref) == [
            "idx", "stack/b0/shift_tm", "stack/b0/shift_cm", "stack/b0/wkv"]
        for name in ref:
            np.testing.assert_allclose(mine[name], np.asarray(ref[name]),
                                       **MODEL, err_msg=name)

    check_state()
    assert int(cache["idx"]) == T
    step_toks = _tokens(cfg, 3, (GEN, B, 1))
    for i in range(GEN):
        jlogits, jcache = jax_decode_step(jcfg, jparams, jcache,
                                          step_toks[i])
        with torch.no_grad():
            logits, cache = decode_step(cfg, params, cache,
                                        torch.from_numpy(step_toks[i]))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **MODEL, err_msg=f"decode step {i}")
    check_state()
    assert int(cache["idx"]) == T + GEN


def test_generate_matches_reference_tokens(pair):
    jcfg, cfg, jparams, params = pair
    toks = _tokens(cfg, 12, (B, 16))
    max_len = serve_max_len(cfg, 16, 8)
    want = JaxServeEngine(jcfg, jparams, max_len=max_len).generate(
        {"tokens": toks}, gen_len=8)
    got = ServeEngine(cfg, params, max_len=max_len, device="cpu").generate(
        {"tokens": toks}, gen_len=8)
    np.testing.assert_array_equal(got, want)


def test_decode_position_invariant():
    """Twin of ``tests/test_long_context.py::
    test_rwkv6_decode_position_invariant``: the recurrent state carries no
    position, so decoding at idx 524,287 (long_500k) gives the logits of
    decoding right after the prompt."""
    cfg = get_config(ARCH, tiny=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(_tokens(cfg, 1, (2, 16)))
    with torch.no_grad():
        lg, cache = prefill(cfg, params, {"tokens": toks},
                            init_cache(cfg, 2, 32, device="cpu"))
        tok = torch.argmax(lg, -1)[:, None].to(torch.int32)

        def fresh(idx):
            c = {"stack": {"b0": rwkv.RWKVState(
                *(t.clone() for t in cache["stack"]["b0"]))},
                "tails": [], "idx": torch.tensor(idx, dtype=torch.int32)}
            return decode_step(cfg, params, c, tok)[0]

        assert torch.equal(fresh(16), fresh(524_287))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _bf16(cfg):
    return dataclasses.replace(cfg, dtype="bfloat16")


def test_bf16_serving_matches_reference(pair):
    """Tiny rwkv6 in bf16 with the perturbed f32 leaves: the port's engine
    (weights cast once by ``cast_params``) against the reference.  Both
    round intermediate bf16 values at other places (the reference's XLA
    fuses elementwise chains), so prefill logits agree to atol 0.1 (their
    max is about 3), the f32 state to 2e-2 of its largest value, and a
    decode step's logits to atol 0.1."""
    jcfg, cfg, jparams, params = pair
    jcfg, cfg = _bf16(jcfg), _bf16(cfg)
    toks = _tokens(cfg, 4, (B, 48))
    jlogits, jcache = jax_prefill(jcfg, jparams, {"tokens": toks},
                                  jax_init_cache(jcfg, B, 64))
    eng = ServeEngine(cfg, params, max_len=64, device="cpu")
    logits, cache = eng.prefill({"tokens": toks})
    assert logits.dtype == torch.bfloat16
    _close(logits.float(), np.asarray(jlogits.astype(jnp.float32)), 0.1)
    jw = np.asarray(jcache["stack"]["b0"].wkv)
    _close(cache["stack"]["b0"].wkv, jw, 2e-2 * np.abs(jw).max())
    tok = np.argmax(np.asarray(jlogits.astype(jnp.float32)), -1)[:, None] \
        .astype(np.int32)
    jlogits, _ = jax_decode_step(jcfg, jparams, jcache, tok)
    with torch.no_grad():
        logits, _ = decode_step(cfg, eng.params, cache, torch.from_numpy(tok))
    _close(logits.float(), np.asarray(jlogits.astype(jnp.float32)), 0.1)


def test_bf16_cast_keeps_the_reference_f32_leaves(pair):
    """The weights a bf16 engine serves with, evaluated in f32, against
    the reference in f32 on its weights rounded to bf16 where it rounds
    them (every matrix and ``mu``) and kept where it uses them in f32
    (norm scales, ``w0``, ``u``, ``gn_scale``, ``gn_bias``): prefill
    logits and state agree to atol 1e-5 + rtol 1e-5, as for f32, so a
    cast of those leaves to bf16 (2^-9 relative) shows."""
    jcfg, cfg, jparams, params = pair
    eng = ServeEngine(_bf16(cfg), params, max_len=T, device="cpu")
    keep = ("scale",) + rwkv.F32_LEAVES
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
    toks = _tokens(cfg, 5, (B, T))
    jlogits, jcache = jax_prefill(jcfg, jrounded, {"tokens": toks},
                                  jax_init_cache(jcfg, B, T))
    served = _map(lambda t: t.float(), eng.params)
    with torch.no_grad():
        logits, cache = prefill(cfg, served,
                                {"tokens": torch.from_numpy(toks)},
                                init_cache(cfg, B, T, device="cpu"))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL)
    np.testing.assert_allclose(cache["stack"]["b0"].wkv.numpy(),
                               np.asarray(jcache["stack"]["b0"].wkv),
                               **MODEL)


# --------------------------------------------------------------------------
# serving-state checkpointing
# --------------------------------------------------------------------------
def test_serving_state_checkpoint(pair):
    """Commit after prefill, restore from the agents: the restored state
    is bit-equal to a second prefill's, and decoding from it gives the
    live run's tokens."""
    _, cfg, _, params = pair
    batch = {"tokens": _tokens(cfg, 6, (B, 10))}
    with ICheckCluster(n_icheck_nodes=1) as cluster:
        client = ICheckClient("serve", cluster.controller).init()
        eng = ServeEngine(cfg, params, max_len=16, device="cpu")
        out = eng.generate(batch, gen_len=5, checkpoint_client=client)
        eng.last_commit.wait(timeout=60)
        restored = eng.restore_serving_state(client, batch_size=B)
        _, fresh = eng.prefill(batch)
        mine, want = _flat(restored), _flat(fresh)
        assert list(mine) == list(want)
        for name in want:
            assert mine[name].dtype == want[name].dtype
            assert mine[name].tobytes() == want[name].tobytes(), name
        assert isinstance(restored["stack"]["b0"], rwkv.RWKVState)
        cont = eng.decode_greedy(restored, out[:, :1], 4)
        np.testing.assert_array_equal(cont, out[:, 1:])
        client.finalize()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_snapshot_regions_match_reference(dtype):
    """The same recurrent state, snapshot by JAX and by the port: the same
    region names, shapes and bytes (bf16 leaves as their uint16 bits)."""
    jcfg = dataclasses.replace(jax_get_config(ARCH, tiny=True), dtype=dtype)
    jparams, _ = jax_init_params(jcfg, jax.random.key(0))
    _, jcache = jax_prefill(jcfg, jparams, {"tokens": _tokens(jcfg, 7,
                                                              (2, 8))},
                            jax_init_cache(jcfg, 2, 8))

    def to_port(x):
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(a))

    st = jcache["stack"]["b0"]
    cache = {"stack": {"b0": rwkv.RWKVState(*(to_port(x) for x in st))},
             "tails": [], "idx": to_port(jcache["idx"])}
    want = jax_snapshot_pytree(jcache)
    got = snapshot_pytree(cache)
    assert list(got.regions) == list(want.regions)
    for name, w in want.regions.items():
        g = got.regions[name]
        assert g.meta.shape == w.meta.shape and g.boxes == w.boxes
        assert g.meta.nbytes == w.meta.nbytes
        want_dtype = "uint16" if w.meta.dtype == "bfloat16" else w.meta.dtype
        assert g.meta.dtype == want_dtype
        assert g.parts[0].tobytes() == np.asarray(w.parts[0]).tobytes()


def test_serve_cli_rwkv6_on_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", ARCH, "--batch", "2", "--prompt-len", "8", "--gen", "4",
          "--icheck", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "generated (2, 4)" in out and "first sequence:" in out

