"""The layout of the port's TMA RG-LRU kernels (K7, ``rglru_sm90.cu`` and
its backward ``rglru_bwd_sm90.cu``) and the routes between K7's two
kernels and its two backwards, checked on the CPU: ``kernel.plan``'s
chunk and ring depth give boxes that TMA takes (inner box rows a multiple
of 16 bytes, at most 256 elements a dimension), rings that fit a CTA's
227 KB of shared memory as the kernel lays it out (and, at
recurrentgemma-9b's prefill, four CTAs an SM), at least 128 CTAs at one
batch row of 4096 channels, and strips and chunks that cover every
channel and token once (the backward's shifted h boxes every h_{t-1}
too); ``ops.route`` and ``ops.route_bwd`` send calls by length and width.
The CPU path itself is unchanged: ``ops.rglru`` hands CPU tensors of any
length to the plain chunked version and their gradients to the plain
backward, which ``tests/test_torch_rglru.py`` and
``tests/test_torch_rglru_grad.py`` hold against the reference.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.rglru import kernel, rglru  # noqa: E402
from repro_torch.kernels.rglru.ops import (SM90_BWD_MIN_T,  # noqa: E402
                                           SM90_MIN_T, route, route_bwd)

SMS = kernel.H100_SMS
SMEM_PER_CTA = 232_448           # 227 KB, the most a CTA may ask for
SMEM_PER_SM = 233_472            # 228 KB an SM on an H100
SMEM_RESERVED = 1024             # the runtime's share of each CTA's
# recurrentgemma-9b's prefill, its ring sub-phase's prefill, a decode step
PREFILL, RING, DECODE = (4, 512, 4096), (1, 2560, 4096), (4, 1, 4096)
# its training step's backward: one 4096-token sequence
TRAIN = (1, 4096, 4096)
RAGGED = [(3, 100, 96), (3, 100, 104), (5, 100, 1000), (1, 300, 104),
          (2, 100, 256), (1, 5, 512), (3, 33, 96), (64, 512, 4096)]


def _smem(tokens, stages, g_bytes):
    """The shared memory of a launch as ``csrc/rglru_sm90.cu`` lays it
    out: a stage the log_a box (f32) and the g box, STRIP channels by
    ``tokens`` rows each, three 8-byte barriers a stage, and room to
    align the ring to 128 bytes."""
    return stages * (kernel.STRIP * tokens * (4 + g_bytes) + 24) + 128


def _smem_bwd(tokens, stages, h_bytes):
    """The shared memory of a launch as ``csrc/rglru_bwd_sm90.cu`` lays it
    out: a stage the log_a and lam boxes (f32) and the dh and shifted h
    boxes (h's type), STRIP channels by ``tokens`` rows each, three 8-byte
    barriers a stage, and room to align the ring to 128 bytes."""
    return stages * (kernel.STRIP * tokens * (2 * 4 + 2 * h_bytes) + 24) \
        + 128


def _ctas(b, d):
    return -(-d // kernel.STRIP) * b


def _check_tma(tokens, stages, b, t, d, g_bytes, smem=_smem):
    """The plan's boxes and ring are ones TMA and a CTA take (shared
    memory laid out by ``smem``), and its strips and chunks cover the
    tensor once."""
    assert tokens in kernel.CHUNKS and kernel.STRIP <= 256 and tokens <= 256
    for elem in (4, g_bytes):
        assert kernel.STRIP * elem % 16 == 0       # inner box rows
    assert smem(tokens, stages, g_bytes) <= SMEM_PER_CTA
    chunks = -(-t // tokens)
    # the helpers refill a stage a chunk after the chain steps it: two
    # stages at least when there is more than one chunk
    assert (2 if chunks > 1 else 1) <= stages <= kernel.STAGES
    assert stages <= chunks and (chunks - 1) * tokens < t <= chunks * tokens
    strips = _ctas(1, d)
    assert (strips - 1) * kernel.STRIP < d <= strips * kernel.STRIP


@pytest.mark.parametrize("g_bytes", [2, 4])
@pytest.mark.parametrize("case", [PREFILL, RING, DECODE] + RAGGED)
def test_plan_is_legal_and_covers_the_tensor(case, g_bytes):
    b, t, d = case
    tokens, stages = kernel.plan(b, t, d)
    _check_tma(tokens, stages, b, t, d, g_bytes)
    # 128-token chunks exactly when every CTA has an SM to itself
    assert (tokens == 128) == (_ctas(b, d) <= SMS)


def test_plan_at_the_serving_shapes():
    """Prefill: 512 CTAs of 32-token chunks, all resident at once, four
    an SM; the ring sub-phase: 128 CTAs, one an SM, 128-token chunks; a
    decode step: one stage."""
    assert kernel.plan(*PREFILL) == (32, 3) and _ctas(4, 4096) == 512
    assert 4 * (_smem(32, 3, 2) + SMEM_RESERVED) <= SMEM_PER_SM
    assert kernel.plan(*RING) == (128, 3) and 128 <= _ctas(1, 4096) <= SMS
    assert kernel.plan(*DECODE) == (32, 1)


@pytest.mark.parametrize("h_bytes", [2, 4])
@pytest.mark.parametrize("case", [TRAIN, PREFILL, RING, DECODE] + RAGGED)
def test_bwd_plan_is_legal_and_covers_the_tensor(case, h_bytes):
    """The backward launches with ``plan`` too: its four boxes a stage
    (log_a, lam, dh, shifted h) fit a CTA in f32 and bf16, and the chunks,
    walked from the last to the first, cover every token once, the shifted
    h boxes every h_{t-1}; only the first chunk's box starts before token
    0 (that row arrives as zeros, and the kernel takes h0 there)."""
    b, t, d = case
    tokens, stages = kernel.plan(b, t, d)
    _check_tma(tokens, stages, b, t, d, h_bytes, smem=_smem_bwd)
    chunks = -(-t // tokens)
    seen, prev_rows, starts = [], set(), []
    for p in range(chunks):                    # the kernel's order
        t0 = (chunks - 1 - p) * tokens
        toks = [x for x in range(t0, t0 + tokens) if x < t]
        seen += toks
        starts.append(t0 - 1)
        prev_rows |= set(range(t0 - 1, t0 - 1 + tokens))
    assert sorted(seen) == list(range(t)) and len(seen) == t
    assert all(x - 1 in prev_rows for x in range(1, t))
    assert [x for x in starts if x < 0] == [-1] and starts[-1] == -1


def test_bwd_plan_at_the_training_shape():
    """recurrentgemma-9b's training step: 128 CTAs, one an SM, 128-token
    chunks through three stages; 144 KB of shared memory in bf16, 192 KB
    in f32."""
    assert kernel.plan(*TRAIN) == (128, 3) and _ctas(1, 4096) == 128 <= SMS
    assert _smem_bwd(128, 3, 2) == 147_656
    assert _smem_bwd(128, 3, 4) == 196_808 <= SMEM_PER_CTA


@pytest.mark.parametrize("case,want", [
    ((4, 1, 4096), (32, 1)),       # one chunk: one stage
    ((4, 32, 4096), (32, 1)),
    ((4, 33, 4096), (32, 2)),      # two chunks: the least ring that turns
    ((4, 64, 4096), (32, 2)),
    ((4, 65, 4096), (32, 3)),
    ((4, 320, 4096), (32, 3)),     # many chunks: STAGES, phases wrap
    ((1, 128, 4096), (128, 1)),
    ((1, 129, 4096), (128, 2)),
    ((1, 2560, 4096), (128, 3)),
    ((1, 320, 100), (128, 3)),
])
def test_plan_depth_by_length(case, want):
    """The ring's depth follows T: one stage a chunk up to STAGES, so the
    card tests reach one, two and three stages (and the barrier phases'
    wrap) through T alone."""
    assert kernel.plan(*case) == want


@pytest.mark.parametrize("args", [(0, 64, 128), (1, 0, 128), (1, 64, 0),
                                  (-1, 64, 128)])
def test_plan_refuses(args):
    with pytest.raises(ValueError, match="no plan"):
        kernel.plan(*args)


def test_row_multiple():
    assert kernel.row_multiple(torch.float32) == 4
    assert kernel.row_multiple(torch.bfloat16) == 8
    assert kernel.row_multiple(torch.float16) == 0     # no kernel takes it


@pytest.mark.parametrize("t,d,dtype,want", [
    (1, 4096, torch.bfloat16, "rglru"),           # a decode step
    (SM90_MIN_T - 1, 4096, torch.bfloat16, "rglru"),
    (SM90_MIN_T, 4096, torch.bfloat16, "rglru_sm90"),
    (512, 4096, torch.bfloat16, "rglru_sm90"),    # prefill
    (2560, 4096, torch.float32, "rglru_sm90"),
    (512, 100, torch.bfloat16, "rglru"),          # rows TMA cannot read
    (512, 100, torch.float32, "rglru_sm90"),
    (512, 98, torch.float32, "rglru"),
    (512, 4096, torch.float16, "rglru"),          # which raises on its dtype
])
def test_route(t, d, dtype, want):
    assert route(t, d, dtype) == want


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("t", [1, SM90_MIN_T, 2560])
def test_cpu_route_is_the_plain_version(monkeypatch, t, with_h0):
    """CPU tensors of any length, those a CUDA call would send to the TMA
    kernel too, go to ``rglru_chunked`` with the caller's tensors, and
    no kernel launches (``tests/test_torch_rglru.py`` holds that path
    against the reference's oracle and XLA path)."""
    from repro_torch.kernels.rglru import ops

    calls = []

    def spy(*args):
        calls.append(args)
        return "plain"

    monkeypatch.setattr(ops, "rglru_chunked", spy)
    la = torch.zeros((1, t, 8))
    g = torch.zeros((1, t, 8), dtype=torch.bfloat16)
    h0 = torch.zeros((1, 8)) if with_h0 else None
    n0 = (kernel.launches, kernel.sm90_launches)
    assert rglru(la, g, h0) == "plain"
    assert (kernel.launches, kernel.sm90_launches) == n0
    assert len(calls) == 1 and calls[0][0] is la and calls[0][1] is g \
        and calls[0][2] is h0


@pytest.mark.parametrize("t,d,dtype,want", [
    (1, 4096, torch.bfloat16, "rglru_bwd"),
    (SM90_BWD_MIN_T - 1, 4096, torch.bfloat16, "rglru_bwd"),
    (SM90_BWD_MIN_T, 4096, torch.bfloat16, "rglru_bwd_sm90"),
    (SM90_BWD_MIN_T + 1, 4096, torch.bfloat16, "rglru_bwd_sm90"),
    (4096, 4096, torch.bfloat16, "rglru_bwd_sm90"),   # training
    (4096, 4096, torch.float32, "rglru_bwd_sm90"),
    (4096, 100, torch.bfloat16, "rglru_bwd"),         # rows TMA cannot read
    (4096, 104, torch.bfloat16, "rglru_bwd_sm90"),    # 8 | D, 32 does not
    (4096, 100, torch.float32, "rglru_bwd_sm90"),
    (4096, 98, torch.float32, "rglru_bwd"),
    (4096, 4096, torch.float16, "rglru_bwd"),         # which raises on it
])
def test_route_bwd(t, d, dtype, want):
    assert route_bwd(t, d, dtype) == want


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("t", [1, SM90_BWD_MIN_T])
def test_cpu_backward_is_the_plain_backward(monkeypatch, t, with_h0):
    """The gradients of CPU tensors of any length, those a CUDA call would
    send to the TMA backward too, come from ``rglru_bwd_ref`` with the
    forward's saved log_a, h and h0, and no kernel launches."""
    from repro_torch.kernels.rglru import ops

    calls = []
    real = ops.rglru_bwd_ref

    def spy(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(ops, "rglru_bwd_ref", spy)
    gen = torch.Generator().manual_seed(t)
    la = (-torch.rand((1, t, 8), generator=gen)).requires_grad_()
    g = torch.randn((1, t, 8), generator=gen).requires_grad_()
    h0 = torch.randn((1, 8), generator=gen).requires_grad_() \
        if with_h0 else None
    counts = ("launches", "sm90_launches", "bwd_launches",
              "bwd_sm90_launches")
    n0 = [getattr(kernel, c) for c in counts]
    h, h_last = rglru(la, g, h0)
    (h.sum() + h_last.sum()).backward()
    assert [getattr(kernel, c) for c in counts] == n0
    assert len(calls) == 1 and calls[0][0] is la and calls[0][2] is h0
    assert torch.equal(calls[0][1], h.detach())
    assert la.grad is not None and g.grad is not None
    assert (h0.grad is not None) if with_h0 else True
