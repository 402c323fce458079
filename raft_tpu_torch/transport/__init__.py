"""Device transports (port of ``raft_tpu.transport``; single device only)."""

from raft_tpu_torch.transport.base import Transport, make_transport
from raft_tpu_torch.transport.device import SingleDeviceTransport

__all__ = ["SingleDeviceTransport", "Transport", "make_transport"]
