"""Device transports (port of ``raft_tpu.transport``): the resident layout
and the replica mesh over ``torch.distributed``."""

from raft_tpu_torch.transport.base import Transport, make_transport
from raft_tpu_torch.transport.device import SingleDeviceTransport
from raft_tpu_torch.transport.mesh import MeshTransport

__all__ = ["MeshTransport", "SingleDeviceTransport", "Transport",
           "make_transport"]
