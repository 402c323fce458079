"""Erasure coding: Reed-Solomon over GF(2^8) for log-shard replication
(port of ``raft_tpu/ec``).

Each replica stores one RS(n, k) shard of every entry; any k live replicas
reconstruct every committed entry (BASELINE config 3).

Layers:
- ``gf``          — GF(2^8) table arithmetic (NumPy; the ground truth)
- ``rs``          — systematic Cauchy RS codec: matrices + NumPy oracle
- ``kernels``     — K6 (parity encode / decode) and K7 (fused encode-fold),
                    CUDA kernels beside their plain bit-sliced versions
- ``reconstruct`` — reconstruction reads, install and heal of a shard row
"""

from raft_tpu_torch.ec.rs import RSCode

__all__ = ["RSCode"]
