"""raft_tpu_torch — the PyTorch/CUDA port of raft_tpu for NVIDIA Hopper.

The JAX package ``raft_tpu`` is the reference; this package runs the same
replication data plane on one H100 with hand-written CUDA kernels
(``csrc/``), each beside a plain PyTorch version of the same function:

- ``core.ring_cuda``  — K1, the fused ring-window write;
- ``core.step_cuda``  — K2 (steady step), K3 (steady flight), K4 (turnover),
  each also in its in-kernel RS parity mode (K2-4·ec);
- ``ec``              — the RS(n, k) erasure-coded data plane: GF(2^8) and
  the codec (``ec.gf``, ``ec.rs``), K6 (parity encode / reconstruction
  decode) and K7 (fused encode-fold) in ``ec.kernels``, reconstruction
  reads and heal in ``ec.reconstruct``; ``northstar.run_device_ec`` drives
  BASELINE config 3;
- ``transport.MeshTransport`` — the replica mesh, one row per rank of a
  ``torch.distributed`` group (``core.comm.MeshComm``), whose steady
  steps run the mesh-local mode of K2-K4 (``core.step_mesh``);
  ``transport.launch.run_ranks`` starts R local ranks;
  ``transport.ReplicaMeshTransport`` the same mesh in one process, one
  block a device, its collectives copies between the blocks' devices
  (``core.comm.BlockComm``);
- ``raft.RaftEngine`` — the engine's tick loop (timers, roles, elections,
  the leader tick, pipelined ingest, commit, the archive and the apply
  stream) over the transports, on the mesh as R lock-step mirrors, one
  rank a replica row (``transport.multihost``), or as one engine over the
  one-process mesh; ``storm`` drives BASELINE config 5;
- ``multi.MultiEngine`` — G independent Raft groups stepped by one batched
  program (kernel K5 in every group launch; the fused K-tick window as a
  CUDA graph), behind the key-routed ``multi.Router``.

Entry points run on CUDA unless the caller passes ``device="cpu"``, which
runs the plain versions. This package never imports JAX.
"""

from raft_tpu_torch._lazy import exports

__all__ = [
    "MeshTransport",
    "MultiEngine",
    "RaftConfig",
    "ReplicaState",
    "Router",
    "SingleDeviceTransport",
    "init_state",
    "make_transport",
]

# resolved on first use: a cluster replica imports the package without
# PyTorch (``raft_tpu_torch._lazy``)
__getattr__ = exports(__name__, {
    "MeshTransport": "transport", "MultiEngine": "multi",
    "RaftConfig": "config", "ReplicaState": "core.state",
    "Router": "multi", "SingleDeviceTransport": "transport",
    "init_state": "core.state", "make_transport": "transport",
})
