"""The bf16 flash-attention checks, one copy for ``chip_smoke.py`` and
``tests/test_torch_kernels_cuda.py`` so that both hold the tensor-core
kernels to the same limits.

* Forward: besides atol on each value, the output's error norm over the
  plain output's norm, on rows with an allowed key, is at most
  ``FWD_REL_BF16``.  Far into a long causal row a typical value is a few
  hundredths, about the atol, so the atol alone would pass a wrong P.V
  there.
* Backward: the kernels round P and dS to bf16 for their products, as
  SDPA does, so each of dq, dk, dv is held against the plain backward run
  on f32 copies of the same bf16 inputs, next to SDPA's gradients against
  the same reference: its max abs error, and its error norm over each tile
  of ``TILE_ROWS`` rows (queries for dq, keys for dk and dv), are at most
  ``BWD_BF16_VS_SDPA`` times SDPA's.  The max abs error is set by the
  largest gradients (the first keys of a causal row); the tiles hold the
  small ones too, so a kernel that is wrong on the last keys fails.
"""
import torch

from repro_torch.kernels.flash_attention.ref import allowed_mask

# four times a bf16 rounding's relative step (2^-9): the output is rounded
# once, and P once before its product with V
FWD_REL_BF16 = 2 ** -7
BWD_BF16_VS_SDPA = 2.0
TILE_ROWS = 64
# SDPA's backend for the yardstick, pinned so that the limit does not move
# with the backend torch would pick: the memory-efficient kernel takes
# every case (a boolean mask, T != S) and rounds P and dS to bf16 as the
# flash backend does
SDPA_BACKEND = "EFFICIENT_ATTENTION"


def fwd_rel_err(out, ref, live) -> float:
    """||out - ref|| / ||ref|| over the rows ``live`` (f32)."""
    o, r = out.float()[:, :, live], ref.float()[:, :, live]
    return ((o - r).norm() / r.norm()).item()


def sdpa_grads(q, k, v, dout, causal, window):
    """SDPA's gradients of the same function, as f32, on the pinned
    backend.  Rows with no allowed key are left out (their gradients are
    zeros); at T = S with no window SDPA's top-left causal mask is the
    bottom-right one, elsewhere it gets the boolean mask.  K and V are
    repeated to the query heads, and their gradients summed in f32 over
    each group and rounded to the inputs' dtype, as SDPA's own GQA
    backward returns them."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    ok = allowed_mask(t, s, causal, window, s - t, q.device)
    live = ok.any(dim=1)
    qg, kg, vg = (x.detach().requires_grad_() for x in (
        q[:, :, live], k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)))
    with sdpa_kernel(getattr(SDPBackend, SDPA_BACKEND)):
        if causal and window is None and t == s:
            out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        else:
            out = F.scaled_dot_product_attention(qg, kg, vg,
                                                 attn_mask=ok[live])
        gq, gk, gv = torch.autograd.grad(out, (qg, kg, vg), dout[:, :, live])
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dq[:, :, live] = gq.float()
    return dq, *(x.float().reshape(b, hkv, g, s, d).sum(2).to(k.dtype)
                 .float() for x in (gk, gv))


def tile_norms(x, tile=TILE_ROWS):
    """The norm of ``x`` (B, H, rows, D) over each tile of ``tile`` rows."""
    rows = x.shape[2]
    pad = -rows % tile
    sq = x.float().square().sum(dim=(0, 1, 3))
    sq = torch.nn.functional.pad(sq, (0, pad))
    return sq.reshape(-1, tile).sum(1).sqrt()


def check_bf16_grads(what, got, want, lib) -> dict:
    """Hold the kernel's (dq, dk, dv) ``got`` and SDPA's ``lib`` against
    the f32 plain backward ``want``; raises AssertionError naming ``what``
    past a limit.  Returns, for each gradient, both max abs errors, both
    error norms over ``want``'s, the worst tile's ratio of the kernel's
    error norm to SDPA's, and ``want``'s rms over all rows and over its
    last tile, so that the margin can be read."""
    res = {}
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, lib):
        g, w, x = g.float(), w.float(), x.float()
        e, e_lib = (g - w).abs().max().item(), (x - w).abs().max().item()
        t_err, t_lib = tile_norms(g - w), tile_norms(x - w)
        # a tile where both are exact (no query sees its keys) has ratio 0
        ratio = torch.where(t_err == 0, torch.zeros_like(t_err),
                            t_err / t_lib)
        worst = int(ratio.argmax())
        n_w = tile_norms(w)
        per_tile = w.numel() / w.shape[2] * TILE_ROWS
        res[name] = {
            "max_abs": e, "sdpa_max_abs": e_lib,
            "rel": (t_err.norm() / n_w.norm()).item(),
            "sdpa_rel": (t_lib.norm() / n_w.norm()).item(),
            "worst_tile": worst, "worst_tile_ratio": ratio[worst].item(),
            "rms": (n_w.norm() / w.numel() ** 0.5).item(),
            "last_tile_rms": (n_w[-1] / per_tile ** 0.5).item()}
        if not e <= BWD_BF16_VS_SDPA * e_lib:
            raise AssertionError(f"{what} {name}: max abs err {e} > "
                                 f"{BWD_BF16_VS_SDPA} x SDPA's {e_lib}")
        if not ratio[worst] <= BWD_BF16_VS_SDPA:
            raise AssertionError(
                f"{what} {name}: error norm over rows "
                f"[{worst * TILE_ROWS}, {(worst + 1) * TILE_ROWS}) is "
                f"{t_err[worst].item()}, > {BWD_BF16_VS_SDPA} x SDPA's "
                f"{t_lib[worst].item()}")
    return res


def summary(res) -> str:
    """One line of ``check_bf16_grads``'s numbers."""
    return ", ".join(
        f"{n} max abs {r['max_abs']:.3e} (SDPA {r['sdpa_max_abs']:.3e}) "
        f"rel {r['rel']:.3e} (SDPA {r['sdpa_rel']:.3e}) worst tile "
        f"{r['worst_tile']} x{r['worst_tile_ratio']:.3f}, |w| rms "
        f"{r['rms']:.3e} last tile {r['last_tile_rms']:.3e}"
        for n, r in res.items())
