"""Systematic Cauchy Reed-Solomon codec: RS(n, k) over GF(2^8) (port of
``raft_tpu/ec/rs.py``).

Generator matrix G (n x k): the top k rows are the identity (data shards
are byte-slices of the entry — systematic, so the fast read path pays no
decode), and the m = n - k parity rows form a Cauchy matrix
``C[p, j] = 1 / (x_p ^ y_j)`` with x_p = k + p, y_j = j. Every square
submatrix of a Cauchy matrix is invertible, so any k of the n shard rows
reconstruct the entry (BASELINE config 3).

This module holds the matrices, the NumPy oracle (``encode``, ``decode``)
and the same two on the C++ host codec (``encode_host``, ``decode_host``,
``raft_tpu_torch.native``: the tiered archive's segment codec). The device
paths — the CUDA kernels K6/K7 and their plain
bit-sliced versions — live in ``raft_tpu_torch.ec.kernels``; the JAX
package's LUT-gather XLA path has no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from raft_tpu_torch.ec import gf


@dataclasses.dataclass(frozen=True)
class RSCode:
    """RS(n, k): n total shards, k data shards, m = n - k parity."""

    n: int
    k: int

    def __post_init__(self):
        if not (1 <= self.k <= self.n <= 256 - self.k):
            raise ValueError("need 1 <= k <= n and distinct Cauchy points")

    @property
    def m(self) -> int:
        return self.n - self.k

    # ---------------------------------------------------------------- matrices
    @property
    def parity_matrix(self) -> np.ndarray:
        """C: u8[m, k] — Cauchy block of the generator."""
        x = np.arange(self.k, self.k + self.m, dtype=np.uint8)[:, None]
        y = np.arange(self.k, dtype=np.uint8)[None, :]
        return gf.inv(x ^ y)

    @property
    def generator(self) -> np.ndarray:
        """G: u8[n, k] — [I_k ; C]."""
        return np.concatenate(
            [np.eye(self.k, dtype=np.uint8), self.parity_matrix]
        )

    def decode_matrix(self, rows: Sequence[int]) -> np.ndarray:
        """u8[k, k] turning shards at ``rows`` (any k distinct) into data."""
        rows = list(rows)
        assert len(rows) == self.k, f"need exactly k={self.k} shard rows"
        return gf.mat_inv(self.generator[rows])

    # ---------------------------------------------------------- NumPy oracle
    def split(self, data: np.ndarray) -> np.ndarray:
        """u8[..., S] -> u8[k, ..., S/k]: byte-slice into data shards."""
        data = np.asarray(data, np.uint8)
        s = data.shape[-1]
        assert s % self.k == 0, "entry bytes must divide by k"
        return np.moveaxis(
            data.reshape(*data.shape[:-1], self.k, s // self.k), -2, 0
        )

    def unsplit(self, shards: np.ndarray) -> np.ndarray:
        """Inverse of ``split``: u8[k, ..., S/k] -> u8[..., S]."""
        return np.moveaxis(np.asarray(shards, np.uint8), 0, -2).reshape(
            *shards.shape[1:-1], shards.shape[0] * shards.shape[-1]
        )

    def encode(self, data: np.ndarray) -> np.ndarray:
        """u8[..., S] entries -> u8[n, ..., S/k] shard rows (row r is what
        replica r stores)."""
        d = self.split(data)                            # [k, ..., S/k]
        prods = gf.mul(
            self.parity_matrix.reshape(self.m, self.k, *([1] * (d.ndim - 1))),
            d[None],
        )
        parity = np.bitwise_xor.reduce(prods, axis=1)   # [m, ..., S/k]
        return np.concatenate([d, parity])

    def decode(self, shards: np.ndarray, rows: Sequence[int]) -> np.ndarray:
        """u8[k, ..., S/k] surviving shards (from ``rows``) -> u8[..., S]."""
        D = self.decode_matrix(rows)
        sh = np.asarray(shards, np.uint8)
        prods = gf.mul(D.reshape(self.k, self.k, *([1] * (sh.ndim - 1))),
                       sh[None])
        return self.unsplit(np.bitwise_xor.reduce(prods, axis=1))

    # ---------------------------------------------------- C++ host codec
    def encode_host(self, data: np.ndarray) -> np.ndarray:
        """``encode`` on the C++ host codec (``raft_tpu_torch.native``,
        built on first use; raises when it cannot be built)."""
        from raft_tpu_torch import native

        d = self.split(np.ascontiguousarray(data))      # [k, ..., S/k]
        return np.concatenate([d, native.apply_matrix(self.parity_matrix,
                                                      d)])

    def decode_host(self, shards: np.ndarray,
                    rows: Sequence[int]) -> np.ndarray:
        """``decode`` on the C++ host codec."""
        from raft_tpu_torch import native

        return self.unsplit(native.apply_matrix(self.decode_matrix(rows),
                                                shards))
