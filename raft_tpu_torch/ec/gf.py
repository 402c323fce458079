"""GF(2^8) arithmetic, table-driven, NumPy (port of ``raft_tpu/ec/gf.py``).

The field is GF(2)[x] / (x^8 + x^4 + x^3 + x^2 + 1) (0x11d, the classic
Reed-Solomon polynomial), with generator 2. Addition is XOR; multiplication
is exp/log table lookup. These tables are the single source of truth for
the port's codec: the NumPy oracle in ``rs``, the bit-decomposition
constants of ``kernels`` and, through them, the CUDA kernels in
``csrc/ec.cu`` and the in-kernel parity of ``csrc/steady.cu``.

The port keeps its own copy (the JAX package's module is NumPy too, but
the port imports nothing of that package); the tests hold the two tables
equal.
"""

from __future__ import annotations

import numpy as np

POLY = 0x11D
ORDER = 255


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(2 * ORDER, np.uint8)   # doubled to skip the mod in a*b
    log = np.zeros(256, np.int32)
    x = 1
    for i in range(ORDER):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    exp[ORDER : 2 * ORDER] = exp[:ORDER]
    return exp, log


EXP, LOG = _build_tables()


def mul(a, b):
    """Elementwise GF(2^8) product of uint8 arrays (0 annihilates)."""
    a = np.asarray(a, np.uint8)
    b = np.asarray(b, np.uint8)
    out = EXP[LOG[a] + LOG[b]]
    return np.where((a == 0) | (b == 0), 0, out).astype(np.uint8)


def inv(a):
    """Multiplicative inverse (a != 0)."""
    a = np.asarray(a, np.uint8)
    if np.any(a == 0):
        raise ZeroDivisionError("0 has no inverse in GF(2^8)")
    return EXP[ORDER - LOG[a]].astype(np.uint8)


def mat_mul(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Matrix product over GF(2^8): XOR-accumulated elementwise products."""
    A = np.asarray(A, np.uint8)
    B = np.asarray(B, np.uint8)
    prods = mul(A[:, :, None], B[None, :, :])        # [i, j, l]
    return np.bitwise_xor.reduce(prods, axis=1)


def mat_inv(A: np.ndarray) -> np.ndarray:
    """Inverse of a square matrix over GF(2^8) (Gauss-Jordan)."""
    A = np.asarray(A, np.uint8).copy()
    n = A.shape[0]
    assert A.shape == (n, n)
    aug = np.concatenate([A, np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        piv = col + int(np.nonzero(aug[col:, col])[0][0])  # raises if singular
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        aug[col] = mul(aug[col], inv(aug[col, col]))
        for row in range(n):
            if row != col and aug[row, col]:
                aug[row] ^= mul(aug[row, col], aug[col])
    return aug[:, n:].copy()


def mul_table(c: int) -> np.ndarray:
    """The 256-entry lookup table for multiplication by constant ``c`` —
    the building block of the XLA/Pallas/C++ encode paths (y = T_c[x])."""
    return mul(np.full(256, c, np.uint8), np.arange(256, dtype=np.uint8))
