"""Device transports (port of ``raft_tpu.transport``): the resident layout,
the replica mesh over ``torch.distributed`` and its multihost placement."""

from raft_tpu_torch.transport.base import Transport, make_transport
from raft_tpu_torch.transport.device import SingleDeviceTransport
from raft_tpu_torch.transport.mesh import MeshTransport
from raft_tpu_torch.transport.multihost import (
    initialize_multihost,
    multihost_transport,
    replica_devices_across_hosts,
)

__all__ = ["MeshTransport", "SingleDeviceTransport", "Transport",
           "initialize_multihost", "make_transport", "multihost_transport",
           "replica_devices_across_hosts"]
