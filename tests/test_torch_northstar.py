"""The slices end to end.

- raft_tpu_torch.northstar.run_device, the JAX package's
  northstar.run_device and the port's golden oracle
  (raft_tpu_torch.northstar.run_golden) consume the same seeded entry
  stream and must produce the same SHA-256 over the committed bytes (the
  port and the JAX device path read them back from follower row 1): at
  B = 128 with 8-byte entries, where the first chunk turns the ring over
  with every row accepting (the turnover flight) and the partial last
  chunk is an infeasible flight, and at the north-star config itself
  (20 480 entries). A run may also continue a cluster that an earlier run
  left, and reports per-step latency on request.
- raft_tpu_torch.northstar.run_device_ec (RS(5,3)) against a JAX
  composition over the same stream: steady_scan_replicate_tpu with the
  in-kernel parity table, then raft_tpu.ec.reconstruct.reconstruct, for a
  systematic and a decoding read set."""

import hashlib
import os
import sys
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from northstar import run_device as jax_run_device  # noqa: E402
from raft_tpu.config import RaftConfig as JConfig  # noqa: E402
from raft_tpu.core import state as jst  # noqa: E402
from raft_tpu.core.step_pallas import steady_scan_replicate_tpu  # noqa: E402
from raft_tpu.ec import kernels as jk  # noqa: E402
from raft_tpu.ec import reconstruct as jrec  # noqa: E402
from raft_tpu.ec.rs import RSCode as JCode  # noqa: E402
from raft_tpu_torch.config import RaftConfig as TConfig  # noqa: E402
from raft_tpu_torch.core import step_cuda  # noqa: E402
from raft_tpu_torch.northstar import (  # noqa: E402
    CHUNK_STEPS,
    run_device,
    run_device_ec,
    run_golden,
)
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


NS_N = 20_480


def test_port_jax_and_golden_agree_at_the_north_star_config():
    """20 480 entries at ``RaftConfig()`` defaults (3 replicas, 256-byte
    entries, B = 1024, C = 32 768), the size ``tests/test_northstar.py``
    certifies: the port on the CPU, the JAX device path and the golden
    oracle hash the same committed bytes."""
    run = run_device(TConfig(), NS_N, seed=3, device="cpu")
    jax_hash, *_ = jax_run_device(JConfig(), NS_N, seed=3,
                                  measure_latency=False)
    assert run.digest == run.input_digest
    assert run.digest == jax_hash
    assert run.digest == run_golden(NS_N, JConfig().entry_bytes, seed=3)
    assert run.state.commit_index.tolist() == [NS_N] * 3


def test_run_reports_per_step_latency():
    """``measure_latency`` adds p50/p99 of per-step time from probe
    flights; on the CPU the method is the host clock."""
    run = run_device(TConfig(**KW), 2 * B + 3, seed=7, device="cpu",
                     measure_latency=True)
    assert run.latency_method == "wall"
    assert np.isfinite(run.p50_us) and np.isfinite(run.p99_us)
    assert 0 < run.p50_us <= run.p99_us
    assert run.digest == run.input_digest
    quiet = run_device(TConfig(**KW), B, seed=7, device="cpu")
    assert quiet.latency_method == "skipped"
    assert np.isnan(quiet.p50_us) and np.isnan(quiet.p99_us)


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


EC_KW = dict(n_replicas=5, entry_bytes=24, batch_size=B, log_capacity=512,
             rs_k=3, rs_m=2, transport="single")
EC_SETS = ((0, 1, 2), (1, 2, 4))
EC_N = 3 * 512 + 200            # three lapping flights and a partial one


def _jax_ec_digests(n_entries, seed):
    """The JAX composition: flights of C // B steps (as run_device_ec
    takes them on this ring) through the steady scan with in-kernel
    parity, each committed window reconstructed from every read set."""
    cfg = JConfig(**EC_KW)
    steps = cfg.log_capacity // B
    code = JCode(5, 3)
    scan = jax.jit(partial(steady_scan_replicate_tpu,
                           commit_quorum=cfg.commit_quorum, interpret=True,
                           stack_infos=False,
                           ec_consts=jk.parity_consts(5, 3)))
    rng = np.random.default_rng(seed)
    st = jst.init_state(cfg)
    hs = {rs: hashlib.sha256() for rs in EC_SETS}
    committed = 0
    while committed < n_entries:
        take = min(n_entries - committed, steps * B)
        # a short flight rides the same program with zero-count tail steps
        counts = np.clip(take - B * np.arange(steps), 0, B).astype(np.int32)
        data = np.zeros((steps * B, cfg.entry_bytes), np.uint8)
        data[:take] = rng.integers(0, 256, (take, cfg.entry_bytes),
                                   dtype=np.uint8)
        wins = data.view(np.int32).reshape(steps, B, -1)
        st, info = scan(st, jnp.asarray(wins), jnp.asarray(counts),
                        jnp.int32(0), jnp.int32(1), jnp.ones(5, bool),
                        jnp.zeros(5, bool), jnp.int32(0), jnp.int32(0), None,
                        jnp.int32(1))
        new = int(info.commit_index)
        assert new == committed + take
        for rs, h in hs.items():
            h.update(jrec.reconstruct(st, code, list(rs), committed + 1,
                                      new).tobytes())
        committed = new
    return {rs: h.hexdigest() for rs, h in hs.items()}


def test_ec_run_matches_jax_composition():
    work = step_cuda.workspace("cpu")
    ran3, ran4 = int(work[step_cuda.WK_RAN3]), int(work[step_cuda.WK_RAN4])
    run = run_device_ec(TConfig(**EC_KW), EC_N, seed=4, device="cpu",
                        read_sets=EC_SETS)
    assert run.flights == 4
    assert int(work[step_cuda.WK_RAN4]) == ran4 + 3     # lapping: turnover
    assert int(work[step_cuda.WK_RAN3]) == ran3 + 1     # partial: K3 flight
    assert run.state.commit_index.tolist() == [EC_N] * 5
    assert run.set_digests == {rs: run.input_digest for rs in EC_SETS}
    assert run.set_digests == _jax_ec_digests(EC_N, seed=4)
