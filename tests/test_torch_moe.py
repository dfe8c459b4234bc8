"""The port's Mixture-of-Experts FFN (``repro_torch/models/moe.py``) held
against the JAX reference's (``repro/models/moe.py``) on the CPU.

Same numpy inputs (a seeded generator, the reference's init scales)
through both, in f32, at tiny dbrx-132b and qwen3-moe-235b-a22b widths,
T in {1, 32, 64} and capacity factors 1.25 and 0.5 (at 0.5, T 32 and 64
drop assignments):

* expert ids (``lax.top_k``'s) and kept assignments (``_dispatch_row``'s)
  identical;
* y within 1e-5 of its largest element, aux within rtol 1e-5 (f32 sums in
  another order);
* gradients of sum(y * r) + aux with respect to x, router, w_gu and
  w_down within 1e-4 of each leaf's largest element;
* ties: duplicate router columns make equal probabilities, and the port
  orders them as ``lax.top_k`` does (the lower expert first).

f32 matmuls run in full precision (``allow_tf32 = False``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch.models import moe  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False

ARCHS = ["dbrx-132b", "qwen3-moe-235b-a22b"]
B = 2
Y_TOL, GRAD_TOL = 1e-5, 1e-4


def _cfg(arch):
    return jax_get_config(arch, tiny=True)


def _inputs(cfg, t, seed=0, tie=None):
    """numpy (params, x, r) at ``cfg``'s widths; ``tie`` maps each router
    column to the column it copies."""
    rng = np.random.default_rng(seed)
    d, e, f = cfg.d_model, cfg.num_experts, cfg.resolved_moe_d_ff
    p = {"router": rng.standard_normal((d, e)) * d ** -0.5,
         "w_gu": rng.standard_normal((2, e, d, f)) * d ** -0.5,
         "w_down": rng.standard_normal((e, f, d)) * f ** -0.5}
    if tie is not None:
        p["router"] = p["router"][:, tie]
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((B, t, d)).astype(np.float32)
    r = rng.standard_normal((B, t, d)).astype(np.float32)
    return p, x, r


def _kw(cfg, cf):
    return dict(num_experts=cfg.num_experts,
                experts_per_token=cfg.experts_per_token, capacity_factor=cf,
                aux_coef=cfg.router_aux_coef)


def _jax_routing(cfg, router, x, cap):
    """The reference's expert ids and kept assignments, by its own
    functions (traceable: jit it)."""
    logits = (x @ router).astype(jnp.float32)
    _, ids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                           cfg.experts_per_token)
    _, _, keep, _ = jax.vmap(lambda xr, ir: jax_moe._dispatch_row(
        xr, ir, None, cap, cfg.num_experts))(x, ids)
    return ids, keep


def _port_routing(cfg, p, x, cap):
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    _, _, ids = moe.route(tp, torch.from_numpy(x), cfg.experts_per_token)
    _, keep = moe.dispatch(ids, cap, cfg.num_experts)
    return ids.numpy(), keep.numpy()


def _close(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err} of {scale}"


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("t", [1, 32, 64])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, t, cf):
    cfg = _cfg(arch)
    p, x, r = _inputs(cfg, t)
    cap = moe.capacity(t, cfg.num_experts, cfg.experts_per_token, cf)
    assert cap == max(int(cfg.experts_per_token * t / cfg.num_experts * cf),
                      1)

    def jloss(jp, jx):
        y, aux = jax_moe.moe_apply(jp, jx, **_kw(cfg, cf))
        return jnp.sum(y * jnp.asarray(r)) + aux, (
            y, aux, _jax_routing(cfg, jp["router"], jx, cap))

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    (_, (jy, jaux, (jids, jkeep))), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    ids, keep = _port_routing(cfg, p, x, cap)
    np.testing.assert_array_equal(ids, np.asarray(jids))
    np.testing.assert_array_equal(keep, np.asarray(jkeep))
    if cf == 0.5 and t > 1:
        assert not keep.all()                 # assignments were dropped

    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_apply(tp, tx, **_kw(cfg, cf))
    assert y.dtype == torch.float32 and aux.dtype == torch.float32
    ((y * torch.from_numpy(r)).sum() + aux).backward()

    _close(y.detach().numpy(), np.asarray(jy), Y_TOL, "y")
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=Y_TOL)
    _close(tx.grad.numpy(), np.asarray(jgx), GRAD_TOL, "dx")
    for name in p:
        _close(tp[name].grad.numpy(), np.asarray(jgp[name]), GRAD_TOL,
               f"d{name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_tied_router_orders_as_lax_top_k(arch):
    """Router columns copied from others: each token sees several equal
    probabilities, and the port picks and orders them as ``lax.top_k``
    (the lower expert first)."""
    cfg = _cfg(arch)
    e = cfg.num_experts
    tie = [j % 3 for j in range(e)][::-1]    # columns 0..2, each repeated
    p, x, _ = _inputs(cfg, 32, seed=3, tie=tie)
    cap = moe.capacity(32, e, cfg.experts_per_token, 1.25)
    ids, keep = _port_routing(cfg, p, x, cap)
    jids, jkeep = jax.jit(lambda r, x: _jax_routing(cfg, r, x, cap))(
        jnp.asarray(p["router"]), jnp.asarray(x))
    np.testing.assert_array_equal(ids, np.asarray(jids))
    np.testing.assert_array_equal(keep, np.asarray(jkeep))
    # the tie is real: the chosen experts' router columns are equal
    first, second = ids[..., 0], ids[..., 1]
    assert (np.asarray(tie)[first] == np.asarray(tie)[second]).any()


@pytest.mark.parametrize("row,want", [
    ([0.1, 0.5, 0.5, 0.2, 0.5], [1, 2]),
    ([0.0] * 8, [0, 1]),
])
def test_top_k_ties_take_the_lower_expert(row, want):
    probs = np.asarray([row], np.float32)
    jids = np.asarray(jax.lax.top_k(jnp.asarray(probs), 2)[1])
    ids = torch.sort(torch.from_numpy(probs), dim=-1, descending=True,
                     stable=True).indices[..., :2].numpy()
    np.testing.assert_array_equal(jids[0], want)
    np.testing.assert_array_equal(ids, jids)
