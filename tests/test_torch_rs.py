"""The port's device Reed-Solomon encode (``ckpt_codec.rs_encode``) on the
CPU: its plain version, bit for bit against the numpy host codec
(``rs.rs_encode_np``) and the reference's Pallas kernel in interpret
mode.  The kernel itself (K5) is held to the same on the card by
``tests/test_torch_kernels_cuda.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ckpt_codec import rs_encode as jax_rs_encode  # noqa: E402
from repro_torch.kernels.ckpt_codec import (rs_decode_np,  # noqa: E402
                                            rs_encode, rs_encode_np,
                                            split_rows)


def _data(k, n, seed):
    return np.random.default_rng(seed).integers(0, 256, size=(k, n),
                                                dtype=np.uint8)


# the cases of tests/test_erasure.py's
# test_rs_encode_kernel_matches_numpy_oracle
@pytest.mark.parametrize("k,m,n", [(4, 1, 1000), (4, 2, 513), (2, 2, 4096)])
def test_plain_rs_encode_matches_numpy_and_reference(k, m, n):
    data = _data(k, n, n)
    want = rs_encode_np(data, m)
    got = rs_encode(torch.from_numpy(data), m=m)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)
    ref = np.asarray(jax_rs_encode(data, m=m, impl="interpret"))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [1, 15, 33, 4097])
def test_plain_rs_encode_unaligned_strides(k, m, n):
    data = _data(k, n, 100 * k + n)
    got = rs_encode(data, m=m)          # a numpy array is a CPU tensor
    np.testing.assert_array_equal(got.numpy(), rs_encode_np(data, m))


def test_parity_rebuilds_lost_rows():
    """A payload split as the L1 erasure path splits it (odd length), its
    parity from ``rs_encode``: any two lost rows come back."""
    payload = np.random.default_rng(1).integers(
        0, 256, 10_007, dtype=np.uint8).tobytes()
    rows = split_rows(payload, 4)
    parity = rs_encode(rows, m=2).numpy()
    frags = {i: rows[i] for i in range(4)}
    frags.update({4 + j: parity[j] for j in range(2)})
    for lost in ((0, 1), (2, 5), (3, 4)):
        kept = {i: f for i, f in frags.items() if i not in lost}
        back = rs_decode_np(kept, 4, 2)
        assert b"".join(np.asarray(r).tobytes() for r in back)[
            :len(payload)] == payload
