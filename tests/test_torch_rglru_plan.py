"""The layout of the port's TMA RG-LRU kernel (K7, ``rglru_sm90.cu``) and
the route between K7's two kernels, checked on the CPU: ``kernel.plan``'s
chunk and ring depth give boxes that TMA takes (inner box rows a multiple
of 16 bytes, at most 256 elements a dimension), rings that fit a CTA's
227 KB of shared memory as the kernel lays it out (and, at
recurrentgemma-9b's prefill, four CTAs an SM), at least 128 CTAs at one
batch row of 4096 channels, and strips and chunks that cover every
channel and token once; ``ops.route`` sends calls by length and width.  The CPU path itself is unchanged: ``ops.rglru`` hands CPU
tensors of any length to the plain chunked version, which
``tests/test_torch_rglru.py`` holds against the reference.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.rglru import kernel, rglru  # noqa: E402
from repro_torch.kernels.rglru.ops import SM90_MIN_T, route  # noqa: E402

SMS = kernel.H100_SMS
SMEM_PER_CTA = 232_448           # 227 KB, the most a CTA may ask for
SMEM_PER_SM = 233_472            # 228 KB an SM on an H100
SMEM_RESERVED = 1024             # the runtime's share of each CTA's
# recurrentgemma-9b's prefill, its ring sub-phase's prefill, a decode step
PREFILL, RING, DECODE = (4, 512, 4096), (1, 2560, 4096), (4, 1, 4096)
RAGGED = [(3, 100, 96), (3, 100, 104), (5, 100, 1000), (1, 300, 104),
          (2, 100, 256), (1, 5, 512), (3, 33, 96), (64, 512, 4096)]


def _smem(tokens, stages, g_bytes):
    """The shared memory of a launch as ``csrc/rglru_sm90.cu`` lays it
    out: a stage the log_a box (f32) and the g box, STRIP channels by
    ``tokens`` rows each, three 8-byte barriers a stage, and room to
    align the ring to 128 bytes."""
    return stages * (kernel.STRIP * tokens * (4 + g_bytes) + 24) + 128


def _ctas(b, d):
    return -(-d // kernel.STRIP) * b


def _check_tma(tokens, stages, b, t, d, g_bytes):
    """The plan's boxes and ring are ones TMA and a CTA take, and its
    strips and chunks cover the tensor once."""
    assert tokens in kernel.CHUNKS and kernel.STRIP <= 256 and tokens <= 256
    for elem in (4, g_bytes):
        assert kernel.STRIP * elem % 16 == 0       # inner box rows
    assert _smem(tokens, stages, g_bytes) <= SMEM_PER_CTA
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
