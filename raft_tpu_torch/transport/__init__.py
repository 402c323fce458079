"""Device transports (port of ``raft_tpu.transport``): the resident layout,
the replica mesh over ``torch.distributed`` and its multihost placement,
the group-axis mesh of multi-Raft, and process-group re-formation."""

from raft_tpu_torch.transport.base import Transport, make_transport
from raft_tpu_torch.transport.device import SingleDeviceTransport
from raft_tpu_torch.transport.group_mesh import (
    GroupMesh,
    GroupMeshTransport,
)
from raft_tpu_torch.transport.mesh import MeshTransport
from raft_tpu_torch.transport.multihost import (
    initialize_multihost,
    multihost_transport,
    replica_devices_across_hosts,
)
from raft_tpu_torch.transport.reform import Epoch, Rendezvous

__all__ = ["Epoch", "GroupMesh", "GroupMeshTransport", "MeshTransport",
           "Rendezvous", "SingleDeviceTransport", "Transport",
           "initialize_multihost", "make_transport", "multihost_transport",
           "replica_devices_across_hosts"]
