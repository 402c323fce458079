"""The port's sharded ``MultiEngine`` on every path after its slot table
has left the identity, against the JAX package's sharded engine in lock
step (``tests/test_torch_multi.py`` ``MPair``; the layout's own cases are
``tests/test_torch_group_shard.py``): the fused window on two shards
(``tests/test_group_shard.py`` ``test_fused_window_sharded_identity``),
then migrations first and every launch, read and decode site after
them. G = 8, 3 replicas, B = 8, C = 256, two shards; the JAX engine on
two of the virtual CPU devices, the port's on ``GroupMesh(["cpu",
"cpu"])``.
"""

import numpy as np

from raft_tpu.obs import device as jdev
from raft_tpu.obs import events as jevents
from raft_tpu_torch.obs import device as tdev
from raft_tpu_torch.obs import events as tevents
from tests.test_torch_group_shard import meshes, sharded_pair
from tests.test_torch_multi import MPair, payloads


def test_fused_window_sharded_identity():
    """``fuse_k`` 8 on two shards: the same fused launches and ticks as
    JAX's sharded engine, in lock step, and fusion engages."""
    p = sharded_pair(8, fuse_k=8)
    p.both("seed_leaders")
    last = p.submit_all({g: payloads(48, seed=200 + g) for g in range(8)})
    p.run_for(300.0)
    for g in range(8):
        assert p.t.is_durable(g, last[g])
    assert p.t.fused_launches > 0, "fusion never engaged"
    p.check_all()


class DevPair(MPair):
    """``MPair`` with flight recorders and the device event ring on both
    sharded engines: the packed rings (the shards' joined in slot order)
    and the decoded events equal after every event."""

    def __init__(self, G, capacity=64, **over):
        super().__init__(G, recorders=(jevents.FlightRecorder(),
                                       tevents.FlightRecorder()),
                         meshes=meshes(), apply=True,
                         **{"transport": "mesh_groups", **over})
        self.jdev = self.j.attach_device_obs(capacity=capacity)
        self.tdev = self.t.attach_device_obs(capacity=capacity)
        self.check()

    def check(self):
        super().check()
        if getattr(self, "tdev", None) is None:
            return
        got = np.concatenate([tdev.packed_flush(r).numpy()
                              for r in self.t._dev_rings])
        np.testing.assert_array_equal(
            got, np.asarray(jdev.packed_flush(self.j._dev_rings)))
        assert [e.to_jsonable() for e in self.tdev.events] == \
            [e.to_jsonable() for e in self.jdev.events]

    def check_all(self):
        super().check_all()
        assert self.t.recorder.to_jsonable() == self.j.recorder.to_jsonable()
        for g in range(self.G):
            for r in range(self.t.cfg.n_replicas):
                assert self.t.committed_payloads(g, r) == \
                    self.j.committed_payloads(g, r), (g, r)


def test_migrate_then_drive_every_path():
    """Two migrations first (the slot table off the identity), then in
    lock step with JAX's sharded engine: fused windows over every group,
    a third migration mid-traffic, then the tick path: a leader kill on a
    moved group and its election, ``read_index``, a slow follower healed;
    the apply stream, the device ring and the status snapshot
    throughout."""
    p = DevPair(8, fuse_k=8)
    p.both("seed_leaders")
    mv = p.both("migrate_group", 1, 1)
    assert mv["partner"] == 4 and p.t.shard_of(1) == 1
    p.both("migrate_group", 6, 0, partner=2)
    assert p.t._slot.tolist() == [0, 4, 6, 3, 1, 5, 2, 7]
    # fused windows over every group (their ticks still share instants)
    last = p.submit_all({g: payloads(24, seed=600 + g) for g in range(8)})
    p.run_for(40.0)
    assert p.t.fused_launches > 0, "no fused window after the moves"
    for g in range(8):
        assert p.t.is_durable(g, last[g]), g
    # a third move mid-traffic
    last = p.submit_all({g: payloads(5, seed=700 + g) for g in (4, 5)})
    p.both("migrate_group", 5, 0)
    for g in (4, 5):
        p.until_committed(g, last[g])
    p.check_all()
    # the tick path on moved groups, and a leader kill on one
    last = p.submit_all({g: payloads(9, seed=400 + g) for g in (1, 6, 2)})
    lead = p.t.leader_id[1]
    p.both("fail", 1, lead)
    p.until_leader(1)
    assert p.t.leader_id[1] != lead
    for g in (1, 6, 2):
        p.until_committed(g, last[g])
    p.both("recover", 1, lead)
    p.both("read_index", 6)
    slow = (p.t.leader_id[4] + 1) % 3
    p.both("set_slow", 4, slow, True)
    p.submit_all({4: payloads(12, seed=500)})
    p.run_for(3.0)
    p.both("set_slow", 4, slow, False)
    p.run_for(3.0)
    assert p.t.migrations == 3
    assert p.t._status_snapshot()["placement"] == \
        p.j._status_snapshot()["placement"]
    p.check_all()
