"""The data-plane serving tier (port of ``raft_tpu/net``; docs/NETWORK.md).

Everything before this package reached the engines as in-process Python
calls; ``raft_tpu_torch.net`` is the wire those calls arrive on — a stdlib
asyncio TCP server speaking a length-prefixed binary protocol
(``protocol``), an ingest loop that coalesces concurrent requests into
batches pre-packed into the device ``StagingRing`` on the network side
of the host/device wall (``server``), and a pooled async client that
reuses the ``admission.retry`` overload discipline (``client``).

Serve an engine with ``IngestServer(EngineBackend(RaftEngine(cfg)))`` (on
the card unless the engine's transport names the CPU) or a ``Router``
over a ``MultiEngine`` with ``RouterBackend(Router(e, drive=False), skv)``;
``await server.start()`` binds the port, ``WireClient(host, port)``
connects to it.
"""

from raft_tpu_torch.net.client import (
    WireClient,
    WireDisconnected,
    WireRefused,
)
from raft_tpu_torch.net.protocol import (
    FrameDecoder,
    FrameTooLarge,
    ProtocolError,
)
from raft_tpu_torch.net.server import (
    EngineBackend,
    IngestServer,
    RouterBackend,
)

__all__ = [
    "EngineBackend",
    "FrameDecoder",
    "FrameTooLarge",
    "IngestServer",
    "ProtocolError",
    "RouterBackend",
    "WireClient",
    "WireDisconnected",
    "WireRefused",
]
