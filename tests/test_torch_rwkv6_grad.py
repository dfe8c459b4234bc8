"""The port's RWKV-6 backward held against the JAX reference, on the CPU.

The same inputs and cotangents, made with numpy from a seed, go through
``jax.grad`` of the reference's ``repro.kernels.rwkv6.ops.rwkv6`` (its
``custom_vjp``, whose backward ``_rwkv6_bwd`` is the vjp of the chunked
``_xla_chunked``) at ``impl="xla"`` and ``impl="ref"``, and through the
port's ``rwkv6`` (its ``autograd.Function``, whose backward on the CPU is
the plain ``rwkv6_bwd_ref``), over the reference kernel tests' sweep, f32
and bf16 r/k/v, from a given s0 and from none, with a nonzero cotangent
of the final state.

Decays below ``LOG_W_MIN`` = -30: the port's forward clamps there (as the
Pallas kernel does), its backward does not (as the reference's does not),
so the gradients are the reference's unclamped ones.

Tolerance: every gradient within 1e-5 of its largest element plus rtol
1e-5 (f32: the chunked vjps sum in other orders); the bf16 gradients of
r, k and v also one bf16 rounding apart (rtol 2^-7).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs files in parallel worker processes: few intra-op threads
# keep this file from crowding the others off the cores
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models  # noqa: E402,F401
from repro.kernels.rwkv6.ops import rwkv6 as jax_rwkv6  # noqa: E402
from repro_torch.kernels.rwkv6 import LOG_W_MIN, rwkv6  # noqa: E402
from repro_torch.kernels.rwkv6.ref import rwkv6_bwd_ref  # noqa: E402

# the sweep of tests/test_kernels_rwkv6.py: (b, h, t, d)
SWEEP = [(2, 3, 130, 64), (1, 2, 64, 32), (1, 1, 7, 16)]
NAMES = ("dr", "dk", "dv", "dlog_w", "du", "ds0")
REL_ATOL = 1e-5


def _inputs(seed, b, h, t, d, with_s0, decay_scale=1.0):
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {
        "r": n(b, h, t, d), "k": n(b, h, t, d) * 0.5, "v": n(b, h, t, d),
        "log_w": (-np.exp(n(b, h, t, d) * 0.5 - 1.0) * decay_scale)
        .astype(np.float32),
        "u": n(h, d) * 0.1,
        "s0": n(b, h, d, d) if with_s0 else None,
        "do": n(b, h, t, d), "dsT": n(b, h, d, d),
    }


def _jax_grads(x, dtype, impl):
    jdt = getattr(jnp, dtype)
    args = [jnp.asarray(x[k]).astype(jdt) for k in ("r", "k", "v")]
    args += [jnp.asarray(x["log_w"]), jnp.asarray(x["u"])]
    if x["s0"] is not None:
        args.append(jnp.asarray(x["s0"]))

    def f(*a):
        o, sT = jax_rwkv6(*a, impl=impl)
        return (jnp.sum(o.astype(jnp.float32) * x["do"])
                + jnp.sum(sT * x["dsT"]))

    grads = jax.grad(f, argnums=tuple(range(len(args))))(*args)
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _port_grads(x, dtype):
    tdt = getattr(torch, dtype)
    leaves = [torch.from_numpy(x[k]).to(tdt).requires_grad_()
              for k in ("r", "k", "v")]
    leaves += [torch.from_numpy(x[k]).requires_grad_()
               for k in ("log_w", "u")]
    if x["s0"] is not None:
        leaves.append(torch.from_numpy(x["s0"]).requires_grad_())
    o, sT = rwkv6(*leaves)
    loss = (o.float() * torch.from_numpy(x["do"])).sum() \
        + (sT * torch.from_numpy(x["dsT"])).sum()
    grads = torch.autograd.grad(loss, leaves)
    for g, leaf in zip(grads, leaves):
        assert g.dtype == leaf.dtype
    return [g.float().numpy() for g in grads]


def _close(got, want, name, dtype, rel_atol=REL_ATOL, scale=None):
    """Within ``rel_atol`` of ``scale`` (by default the largest element of
    ``want``) plus the rtol above."""
    if scale is None:
        scale = float(np.abs(want).max())
    atol = rel_atol * max(scale, 1e-30)
    rtol = 2 ** -7 if dtype == "bfloat16" and name in ("dr", "dk", "dv") \
        else 1e-5
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=name)


@pytest.mark.parametrize("impl", ["xla", "ref"])
@pytest.mark.parametrize("with_s0", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SWEEP)
def test_grads_match_jax(case, dtype, with_s0, impl):
    x = _inputs(sum(case), *case, with_s0)
    want = _jax_grads(x, dtype, impl)
    got = _port_grads(x, dtype)
    assert len(got) == len(want) == 5 + with_s0
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, name, dtype)


@pytest.mark.parametrize("decay_scale", [10.0, 100.0])
def test_grads_below_the_clamp_are_the_unclamped_vjp(decay_scale):
    """log_w scaled so that a share of it lies below -30 (as
    ``test_torch_rwkv6.py::test_extreme_decay_clamped_like_the_kernel``
    scales it): the gradients are the reference's, the vjp of the
    unclamped chunked form, in f32.

    Both sides form exp(L_t - L_i) from cumulative sums L of log_w over a
    chunk of 64 tokens, each rounded in its own order: the exponents
    differ by up to |L| f32 steps, so the products by that relative
    amount.  dlog_w is the reverse cumulative sum of the gradient of L,
    whose terms are as large as dr's and mostly cancel here: so every
    gradient is held within (1e-5 + |L| 2^-23) of the largest gradient of
    the call, plus rtol 1e-5."""
    x = _inputs(9, 2, 2, 70, 32, True)
    x["log_w"] = (-np.exp(np.random.default_rng(10).standard_normal(
        x["log_w"].shape)) * decay_scale).astype(np.float32)
    below = (x["log_w"] < LOG_W_MIN).mean()
    assert 0.05 < below < 0.95, below
    want = _jax_grads(x, "float32", "xla")
    got = _port_grads(x, "float32")
    lw = np.pad(x["log_w"], ((0, 0), (0, 0), (0, 58), (0, 0)))
    L = np.abs(np.cumsum(lw.reshape(2, 2, 2, 64, 32), axis=3)).max()
    top = max(float(np.abs(w).max()) for w in want)
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, name, "float32", REL_ATOL + float(L) * 2.0 ** -23,
               scale=top)


def test_plain_backward_leaves_log_w_unclamped():
    """Where log_w lies below -30 the reference's gradient of log_w is the
    unclamped one: its decay is e^-30 or less, so it is tiny but not zero
    wherever an earlier state still reaches o, which the clamp would make
    exactly zero.  ``rwkv6_bwd_ref`` gives the reference's."""
    x = _inputs(4, 1, 1, 16, 16, True)
    x["log_w"][0, 0, 8] = -31.0       # token 8: just below the clamp
    args = [torch.from_numpy(x[k]) for k in ("r", "k", "v", "log_w", "u",
                                             "s0", "do", "dsT")]
    dlw = rwkv6_bwd_ref(*args[:6], args[6], args[7])[3]
    want = _jax_grads(x, "float32", "xla")[3]
    assert np.all(want[0, 0, 8] != 0)
    _close(dlw.numpy(), want, "dlog_w", "float32")


def test_only_inputs_that_need_grad_get_one():
    """No gradient for an input that needs none; ds0 only for a given
    s0; a call that needs no gradient does not go through the Function."""
    x = _inputs(2, 1, 2, 20, 16, True)
    r, k, v, lw, u, s0 = (torch.from_numpy(x[n]) for n in
                          ("r", "k", "v", "log_w", "u", "s0"))
    v.requires_grad_()
    o, sT = rwkv6(r, k, v, lw, u, s0)
    (o.sum() + sT.sum()).backward()
    assert v.grad is not None
    assert all(t.grad is None for t in (r, k, lw, u, s0))
    o, sT = rwkv6(r, k, v.detach(), lw, u)
    assert o.grad_fn is None and sT.grad_fn is None
