"""The port's transaction drill (``raft_tpu_torch.chaos.txn_run``) against
the JAX package's on the CPU: ``tests/test_txn.py``'s ``TestDrill`` (seed
7, and the broken variants at seed 0) and the txn-only classes of
``tests/test_cluster.py`` (``TestTxnComposedNemeses`` :569,
``TestTxnLeaseReads`` :588), each report held field by field against
JAX's, with the commit-order witness ``check_serializable`` was handed and
the single-key history ``check_history`` was handed, record for record.
Both run on two shards: the port's ``GroupMesh(["cpu", "cpu"])``, JAX's
first two virtual devices. Then the txn-off byte-identity pin
(``test_txn_plane_keeps_torture_byte_identical``) with the port's txn
plane loaded, and ``python -m raft_tpu_torch.chaos --txn``.

Every JAX-side drill of the port's txn tests lives in this file, cached
once a worker (``tests/_torch_chaos.py``), so ``--dist loadfile`` pays
each once."""

import json

import pytest

import raft_tpu_torch.txn  # noqa: F401  (the txn plane loaded)
from raft_tpu_torch.chaos import LINEARIZABLE, VIOLATION
from raft_tpu_torch.transport.group_mesh import GroupMesh
from tests._torch_chaos import assert_same, jax_run, port_run
from tests._torture_fingerprints import fingerprint, plain_membership_run

SERIALIZABLE = "SERIALIZABLE"
#: the seed-7 commit digest ``tests/test_txn.py:509`` pins
SEED7_DIGEST = "6961c982"


def _drill(seed, **kw):
    """The port's drill on two CPU shards, held against JAX's on two
    devices: (port trace, port report)."""
    got, rep = port_run("txn_run", seed, mesh=GroupMesh(["cpu", "cpu"]),
                        **kw)
    assert_same(got, jax_run("txn_run", seed, devices=2, **kw))
    return got, rep


def test_seed7_matches_jax():
    got, rep = _drill(7)
    assert rep.verdict == SERIALIZABLE
    assert rep.conserved_ok and not rep.caught
    assert rep.singles.verdict == LINEARIZABLE
    assert rep.committed >= 1 and rep.aborted >= 0
    assert rep.moves and len(rep.nemeses) == 3
    assert rep.unresolved == 0
    assert rep.commit_digest == SEED7_DIGEST
    assert rep.repro == "python -m raft_tpu_torch.chaos --txn --seed 7"
    witness, singles = got["histories"]
    assert len(witness) == rep.txns + 1 and len(singles) > 0


def test_seed7_extra_nemeses_matches_jax():
    _, rep = _drill(7, extra_nemeses=True)
    assert rep.verdict == SERIALIZABLE
    assert rep.singles.verdict == LINEARIZABLE
    assert rep.conserved_ok
    kinds = [n.split()[0] for n in rep.nemeses]
    assert kinds == ["kill", "partition", "migrate",
                     "mem_replace", "wire_slow", "overload"]
    assert "--txn-extra" in rep.repro


def test_seed7_lease_reads_match_jax():
    _, rep = _drill(7, lease_reads=True)
    assert rep.verdict == SERIALIZABLE and rep.conserved_ok
    assert rep.singles.verdict == LINEARIZABLE
    assert rep.commit_digest == SEED7_DIGEST     # == plain seed 7
    assert rep.unresolved == 0
    assert rep.read_certs.get("lease", 0) > 0
    assert rep.read_certs["lease"] > rep.read_certs.get("read_index", 0)
    assert "--txn-lease-reads" in rep.repro


@pytest.mark.parametrize("broken", ["txn_partial_commit",
                                    "txn_dirty_read"])
def test_broken_variant_is_caught_as_jax(broken):
    _, rep = _drill(0, broken=broken)
    assert rep.caught
    assert rep.verdict == VIOLATION
    assert not rep.conserved_ok


def test_without_two_shards_raises_jax_text():
    from raft_tpu_torch.chaos import txn_run

    with pytest.raises(RuntimeError, match="txn_run needs a sharded "
                       r"layout \(>= 2 devices for the gshard axis; "
                       "engine degraded to 'single'\\)"):
        txn_run(7, device="cpu")


@pytest.mark.parametrize("seed", [11, 22])
def test_txn_plane_keeps_torture_byte_identical(seed):
    """With the port's txn plane loaded (this module imports it), the
    single-engine membership torture run stays the JAX package's, op for
    op, and its fingerprint the plain baseline's."""
    got, rep = port_run("torture_run", seed, phases=4, membership=True)
    assert_same(got, jax_run("torture_run", seed, phases=4,
                             membership=True))
    assert fingerprint(rep) == plain_membership_run(seed)


def test_cli_txn_runs_the_drill(capsys):
    from raft_tpu_torch.chaos.__main__ import main

    assert main(["--txn", "--seed", "7", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert out[-2].startswith("seed=7 verdict=SERIALIZABLE")
    assert (line["verdict"], line["singles"]) == (SERIALIZABLE, LINEARIZABLE)
    assert line["commit_digest"] == SEED7_DIGEST
    assert line["conserved_ok"] and line["unresolved"] == 0
    assert [m["dst"] for m in line["moves"]] == [1]
