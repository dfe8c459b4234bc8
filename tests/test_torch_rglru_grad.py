"""The port's RG-LRU backward held against the JAX reference, on the CPU.

The same inputs and cotangents, made with numpy from a seed, go through
``jax.grad`` of the reference's ``repro.kernels.rglru.ops.rglru`` (its
``custom_vjp``, the analytic reverse scan ``_rglru_bwd``) at
``impl="xla"`` and ``impl="ref"``, and through the port's ``rglru`` (its
``autograd.Function``, whose backward on the CPU is the plain
``rglru_bwd_ref``), over the reference kernel tests' sweep, with h0 and
without, f32 and bf16 g, and a nonzero cotangent of h_final.

Tolerance: dlog_a, dg and dh0 within 1e-5 of the largest gradient of
their kind plus rtol 1e-5 (f32: the two reverse scans sum in other
orders); bf16 g adds one bf16 rounding of dg (rtol 2^-7) and of the
forward's saved h, which enters dlog_a (rtol 2^-7 there too).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs files in parallel worker processes: few intra-op threads
# keep this file from crowding the others off the cores
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

# the reference's models first: importing repro.kernels.rglru before them
# leaves repro.models.rglru_layer holding the module in place of the op
import repro.models  # noqa: E402,F401
from repro.kernels.rglru.ops import rglru as jax_rglru  # noqa: E402
from repro_torch.kernels.rglru import rglru  # noqa: E402
from repro_torch.kernels.rglru.ref import rglru_bwd_ref  # noqa: E402

# the sweep of tests/test_kernels_rglru.py: (b, t, d)
SWEEP = [(2, 100, 256), (1, 64, 128), (1, 5, 512), (3, 33, 96)]
RTOL = {"float32": 1e-5, "bfloat16": 2 ** -7}
REL_ATOL = 1e-5


def _inputs(seed, b, t, d, with_h0):
    rng = np.random.default_rng(seed)
    return {
        # decays from 0.99 (long memory) to 0.05 (forgets at once)
        "log_a": -rng.uniform(0.01, 3.0, (b, t, d)).astype(np.float32),
        "g": rng.standard_normal((b, t, d)).astype(np.float32),
        "h0": rng.standard_normal((b, d)).astype(np.float32)
        if with_h0 else None,
        "dh": rng.standard_normal((b, t, d)).astype(np.float32),
        "dh_last": rng.standard_normal((b, d)).astype(np.float32),
    }


def _jax_grads(x, dtype, impl):
    jdt = getattr(jnp, dtype)
    g = jnp.asarray(x["g"]).astype(jdt)
    h0 = None if x["h0"] is None else jnp.asarray(x["h0"])

    def f(log_a, g, h0):
        h, h_last = jax_rglru(log_a, g, h0, impl=impl)
        return (jnp.sum(h.astype(jnp.float32) * x["dh"])
                + jnp.sum(h_last * x["dh_last"]))

    argnums = (0, 1) if h0 is None else (0, 1, 2)
    grads = jax.grad(f, argnums=argnums)(jnp.asarray(x["log_a"]), g, h0)
    return [np.asarray(gr.astype(jnp.float32)) for gr in grads]


def _port_grads(x, dtype):
    la = torch.from_numpy(x["log_a"]).requires_grad_()
    g = torch.from_numpy(x["g"]).to(getattr(torch, dtype)).requires_grad_()
    leaves = [la, g]
    h0 = None
    if x["h0"] is not None:
        h0 = torch.from_numpy(x["h0"]).requires_grad_()
        leaves.append(h0)
    h, h_last = rglru(la, g, h0)
    assert h.dtype == g.dtype and h_last.dtype == torch.float32
    loss = (h.float() * torch.from_numpy(x["dh"])).sum() \
        + (h_last * torch.from_numpy(x["dh_last"])).sum()
    grads = torch.autograd.grad(loss, leaves)
    assert grads[1].dtype == g.dtype and grads[0].dtype == torch.float32
    return [gr.float().numpy() for gr in grads]


def _close(got, want, dtype, name):
    atol = REL_ATOL * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=RTOL[dtype], atol=atol,
                               err_msg=name)


@pytest.mark.parametrize("impl", ["xla", "ref"])
@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SWEEP)
def test_grads_match_jax(case, dtype, with_h0, impl):
    x = _inputs(sum(case), *case, with_h0)
    want = _jax_grads(x, dtype, impl)
    got = _port_grads(x, dtype)
    assert len(got) == len(want)
    for name, g, w in zip(("dlog_a", "dg", "dh0"), got, want):
        _close(g, w, dtype, name)


@pytest.mark.parametrize("with_h0", [True, False])
def test_plain_backward_matches_the_reference_residual_formula(with_h0):
    """``rglru_bwd_ref`` from the forward's saved bf16 h, as the
    reference's ``_rglru_bwd`` takes it, against that function's own
    output on the same residuals (f32, the tolerance above)."""
    from repro.kernels.rglru.ops import _rglru_bwd, _rglru_fwd

    x = _inputs(3, 2, 40, 64, with_h0)
    la = jnp.asarray(x["log_a"])
    g = jnp.asarray(x["g"]).astype(jnp.bfloat16)
    h0 = None if x["h0"] is None else jnp.asarray(x["h0"])
    (h, _), res = _rglru_fwd(la, g, h0, 64, "xla")
    want = _rglru_bwd(64, "xla", res, (jnp.asarray(x["dh"]).astype(
        jnp.bfloat16), jnp.asarray(x["dh_last"])))
    th = torch.from_numpy(np.array(h.astype(jnp.float32))).bfloat16()
    got = rglru_bwd_ref(torch.from_numpy(x["log_a"]), th,
                        None if h0 is None else torch.from_numpy(x["h0"]),
                        torch.from_numpy(x["dh"]).bfloat16(),
                        torch.from_numpy(x["dh_last"]))
    assert got[1].dtype == torch.bfloat16 and (got[2] is None) == (h0 is None)
    for name, gr, w in zip(("dlog_a", "dg", "dh0"), got, want):
        if w is None:
            continue
        _close(gr.float().numpy(), np.asarray(w.astype(jnp.float32)),
               "bfloat16" if name == "dg" else "float32", name)


def test_only_inputs_that_need_grad_get_one():
    """The Function returns no gradient for an input that needs none, and
    a call that needs no gradient does not go through it."""
    x = _inputs(5, 1, 9, 32, True)
    la = torch.from_numpy(x["log_a"])
    g = torch.from_numpy(x["g"]).requires_grad_()
    h0 = torch.from_numpy(x["h0"])
    h, _ = rglru(la, g, h0)
    assert h.grad_fn is not None
    h.sum().backward()
    assert g.grad is not None and la.grad is None and h0.grad is None
    h, h_last = rglru(la, g.detach(), h0)
    assert h.grad_fn is None and h_last.grad_fn is None


def test_grad_through_h_final_only():
    """h unused (no cotangent for it): the gradients are those of h_final
    alone, the reverse scan started from dh_last."""
    x = _inputs(6, 2, 17, 48, True)
    leaves = [torch.from_numpy(x[k]).requires_grad_()
              for k in ("log_a", "g", "h0")]
    _, h_last = rglru(*leaves)
    got = torch.autograd.grad((h_last * torch.from_numpy(x["dh_last"]))
                              .sum(), leaves)
    x["dh"] = np.zeros_like(x["dh"])
    want = _jax_grads(x, "float32", "xla")
    for name, g, w in zip(("dlog_a", "dg", "dh0"), got, want):
        _close(g.numpy(), w, "float32", name)
