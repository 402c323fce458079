"""The slice end to end: raft_tpu_torch.northstar.run_device, the JAX
package's northstar.run_device and the golden oracle consume the same
seeded entry stream and must produce the same SHA-256 over the committed
bytes (the port and the JAX device path read them back from follower
row 1). The first chunk turns the ring over with every row accepting (the
turnover flight); the partial last chunk is an infeasible flight. A run
may also continue a cluster that an earlier run left."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from northstar import run_device as jax_run_device, run_golden  # noqa: E402
from raft_tpu.config import RaftConfig as JConfig  # noqa: E402
from raft_tpu_torch.config import RaftConfig as TConfig  # noqa: E402
from raft_tpu_torch.core import step_cuda  # noqa: E402
from raft_tpu_torch.northstar import CHUNK_STEPS, run_device  # noqa: E402
from raft_tpu_torch.transport.device import SingleDeviceTransport  # noqa: E402

B = 128
KW = dict(n_replicas=3, entry_bytes=8, batch_size=B,
          log_capacity=CHUNK_STEPS * B)
N = CHUNK_STEPS * B + 5 * B + 37


def test_port_jax_and_golden_hashes_agree():
    work = step_cuda.workspace("cpu")
    ran3, ran4 = int(work[step_cuda.WK_RAN3]), int(work[step_cuda.WK_RAN4])
    run = run_device(TConfig(**KW), N, seed=3, device="cpu")
    port_hash = run.digest
    assert int(work[step_cuda.WK_RAN4]) == ran4 + 1     # chunk 1: turnover
    assert int(work[step_cuda.WK_RAN3]) == ran3 + 1     # chunk 2: K3 flight
    jax_hash, *_ = jax_run_device(JConfig(**KW), N, seed=3,
                                  measure_latency=False)
    assert port_hash == jax_hash
    assert port_hash == run_golden(N, KW["entry_bytes"], seed=3, batch=B)
    assert port_hash == run.input_digest


def test_run_continues_a_cluster():
    """A second run on the first one's transport and state appends its
    own stream after the first's entries; both followers read it back."""
    cfg = TConfig(**KW)
    first = run_device(cfg, CHUNK_STEPS * B, seed=5, device="cpu",
                       rows=(1, 2))
    tr = SingleDeviceTransport(cfg, device="cpu")
    second = run_device(cfg, 3 * B + 7, seed=6, transport=tr,
                        state=first.state, rows=(1, 2))
    assert first.row_digests == {1: first.input_digest,
                                 2: first.input_digest}
    assert second.row_digests == {1: second.input_digest,
                                  2: second.input_digest}
    assert second.input_digest != first.input_digest
    total = (CHUNK_STEPS + 3) * B + 7
    assert second.state.commit_index.tolist() == [total] * 3
