"""GF(2^8) Reed-Solomon k+m erasure codec — jax-free numpy reference.

One shared definition of the stripe math: the host-side fragment codec in
``repro.core.tiers`` (the commit/rebuild/restore data path) and the Pallas
encode kernels in :mod:`.rs_kernel` both derive from the tables and the
generator defined here, so the device kernels and the durability layer
cannot drift.  Everything below is plain numpy — importable by the agents
and the catalog without touching jax.

Layout: a shard payload is split into ``k`` contiguous data fragments
(stride = ceil(len/k), zero-padded), viewed as uint8 rows of one matrix
``D`` of shape (k, stride).  ``m`` parity rows are ``P = C @ D`` over
GF(2^8) with the Vandermonde-style generator ``C[j][i] = g^(j*i)``
(g = 2, the primitive element of the field under ``_PRIM_POLY``):

  * row 0 is all-ones — parity 0 is the pure XOR of the data rows, so the
    single-parity (m=1) hot path never multiplies;
  * rows 0..m-1 for m <= 2 form an MDS code (the classic RAID-6
    construction): *any* k of the k+m fragments reconstruct the payload.

Decode inverts the k x k matrix of surviving rows (Gauss-Jordan in
GF(2^8)) and multiplies it back onto the surviving fragments.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

# x^8 + x^4 + x^3 + x^2 + 1 — the AES/QR-code field polynomial
_PRIM_POLY = 0x11D
_GENERATOR = 2


def _build_tables():
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= _PRIM_POLY
    exp[255:510] = exp[:255]       # wraparound so mul never reduces mod 255
    return exp, log


GF_EXP, GF_LOG = _build_tables()


def gf_mul(a: int, b: int) -> int:
    """Scalar GF(2^8) multiply (tables)."""
    if a == 0 or b == 0:
        return 0
    return int(GF_EXP[int(GF_LOG[a]) + int(GF_LOG[b])])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("gf_inv(0)")
    return int(GF_EXP[255 - int(GF_LOG[a])])


def gf_mul_row(coef: int, row: np.ndarray) -> np.ndarray:
    """Multiply a uint8 vector by one GF(2^8) constant (vectorized tables)."""
    if coef == 0:
        return np.zeros_like(row)
    if coef == 1:
        return row.copy()
    shift = int(GF_LOG[coef])
    out = np.zeros_like(row)
    nz = row != 0
    out[nz] = GF_EXP[GF_LOG[row[nz].astype(np.int32)] + shift]
    return out


def rs_generator_matrix(k: int, m: int) -> np.ndarray:
    """(m, k) parity generator: coef[j][i] = g^(j*i); row 0 = all ones."""
    if k < 1 or m < 0:
        raise ValueError(f"need k >= 1 and m >= 0, got k={k} m={m}")
    if m > 2:
        # rows g^(j*i) are only guaranteed MDS for m <= 2 (RAID-6); keep
        # the promise honest instead of silently weakening durability
        raise ValueError(f"m <= 2 supported by this generator, got m={m}")
    coef = np.zeros((m, k), dtype=np.uint8)
    for j in range(m):
        for i in range(k):
            coef[j, i] = GF_EXP[(j * i) % 255]
    return coef


def rs_encode_np(data_rows: np.ndarray, m: int) -> np.ndarray:
    """(k, stride) uint8 data rows -> (m, stride) parity rows, P = C @ D."""
    data_rows = np.ascontiguousarray(data_rows, dtype=np.uint8)
    k = data_rows.shape[0]
    coef = rs_generator_matrix(k, m)
    parity = np.zeros((m, data_rows.shape[1]), dtype=np.uint8)
    for j in range(m):
        acc = np.zeros(data_rows.shape[1], dtype=np.uint8)
        for i in range(k):
            acc ^= gf_mul_row(int(coef[j, i]), data_rows[i])
        parity[j] = acc
    return parity


def _gf_matrix_inv(mat: np.ndarray) -> np.ndarray:
    """Invert a (k, k) GF(2^8) matrix by Gauss-Jordan elimination."""
    k = mat.shape[0]
    a = mat.astype(np.uint8).copy()
    inv = np.eye(k, dtype=np.uint8)
    for col in range(k):
        pivot = next((r for r in range(col, k) if a[r, col]), None)
        if pivot is None:
            raise ValueError("survivor matrix is singular (not enough "
                             "independent fragments)")
        if pivot != col:
            a[[col, pivot]] = a[[pivot, col]]
            inv[[col, pivot]] = inv[[pivot, col]]
        piv_inv = gf_inv(int(a[col, col]))
        a[col] = gf_mul_row(piv_inv, a[col])
        inv[col] = gf_mul_row(piv_inv, inv[col])
        for r in range(k):
            if r != col and a[r, col]:
                f = int(a[r, col])
                a[r] ^= gf_mul_row(f, a[col])
                inv[r] ^= gf_mul_row(f, inv[col])
    return inv


def rs_decode_np(fragments: Dict[int, np.ndarray], k: int,
                 m: int) -> np.ndarray:
    """Reconstruct the (k, stride) data rows from any k surviving fragments.

    ``fragments`` maps fragment index -> uint8 row, where indices 0..k-1
    are data rows and k..k+m-1 are parity rows.  Raises ``ValueError``
    when fewer than k fragments survive.
    """
    if len(fragments) < k:
        raise ValueError(f"need {k} fragments to decode, have "
                         f"{len(fragments)}")
    have_data = [i for i in sorted(fragments) if i < k]
    if len(have_data) == k:        # healthy read: no field math at all
        return np.stack([np.asarray(fragments[i], dtype=np.uint8)
                         for i in range(k)])
    coef = rs_generator_matrix(k, m)
    # full (k+m, k) encode matrix: identity on top, parity rows below
    full = np.vstack([np.eye(k, dtype=np.uint8), coef])
    use: List[int] = sorted(fragments)[:k]
    sub = full[use]
    inv = _gf_matrix_inv(sub)
    rows = [np.asarray(fragments[i], dtype=np.uint8) for i in use]
    stride = rows[0].shape[0]
    data = np.zeros((k, stride), dtype=np.uint8)
    for r in range(k):
        acc = np.zeros(stride, dtype=np.uint8)
        for c in range(k):
            acc ^= gf_mul_row(int(inv[r, c]), rows[c])
        data[r] = acc
    return data


def split_rows(payload: bytes, k: int) -> np.ndarray:
    """bytes -> (k, stride) uint8 rows, stride = ceil(len/k), zero-padded."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    stride = max(1, -(-len(payload) // k))
    buf = np.zeros(k * stride, dtype=np.uint8)
    buf[:len(payload)] = np.frombuffer(payload, dtype=np.uint8)
    return buf.reshape(k, stride)


def join_rows(rows: Sequence[np.ndarray], orig_len: int) -> bytes:
    """Inverse of :func:`split_rows`: concat data rows, strip the padding."""
    return np.concatenate([np.asarray(r, dtype=np.uint8)
                           for r in rows]).tobytes()[:orig_len]
