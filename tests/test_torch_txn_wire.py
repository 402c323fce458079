"""The server's TXN half in the port (``IngestServer(txn=)``) against the
JAX package's on the CPU: ``tests/test_txn.py``'s ``TestTxnWire`` in all
four client/server pairings of the two packages, through
``tests/_torch_net.py``'s recording ``Proxy``. Every frame each side sends
(HELLO/WELCOME with CAP_TXN, TXN_BEGIN/COMMIT/STATUS/ABORT, TXN_STATE,
the reads and submits around them) must equal the JAX pairing's byte for
byte, and so must the results, the server's ``stats()`` and ``txn``
status section, and the stores left behind. Two more sessions pin the
server's adoption of a transaction it stops waiting for: one past the op
timeout (the sweep adopts it), one whose pump dies (``_fail_all`` adopts
it); either way the coordinator finishes it and no lock is left held."""

import asyncio
import importlib

import pytest

from tests._torch_net import Proxy, engine_cfg, pkg, reset_counters

JX, PT = pkg("raft_tpu"), pkg("raft_tpu_torch")
PAIRS = [(c, s) for c in (JX, PT) for s in (JX, PT)]


def _txn_stack(ns, G=4, **cfg_kw):
    txn = importlib.import_module(f"{ns.name}.txn")
    eng = ns.multi(engine_cfg(ns, **cfg_kw), G)
    router = ns.Router(eng, drive=False)
    skv = txn.TxnShardedKV(eng, router)
    eng.seed_leaders()
    coord = txn.TxnCoordinator(skv, decision_group=0)
    return eng, router, skv, coord


def _res(r):
    """A client result as plain values."""
    return (type(r).__name__,) + tuple(getattr(r, s)
                                       for s in type(r).__slots__)


async def _expect_error(ns, coro):
    with pytest.raises(ns.client.WireError) as ei:
        await coro
    return (type(ei.value).__name__, str(ei.value))


def _session(client_ns, server_ns, scenario, armed=True, client_kw=None,
             **server_kw):
    """``scenario(client, ns)`` of ``client_ns``'s client against
    ``server_ns``'s server (a coordinator attached when ``armed``) through
    a recording proxy: (results, client frames, server frames, stats,
    txn section, stores, locks held)."""
    reset_counters()
    eng, router, skv, coord = _txn_stack(server_ns)
    board = server_ns.StatusBoard()

    async def main():
        srv = server_ns.net.IngestServer(
            server_ns.net.RouterBackend(router, skv),
            txn=coord if armed else None, status_board=board,
            drive_quantum_s=eng.cfg.heartbeat_period, **server_kw)
        proxy = Proxy(await srv.start())
        c = await client_ns.net.WireClient(
            "127.0.0.1", await proxy.start(),
            **({"txn": True} if client_kw is None else client_kw)).connect()
        out = [c._conns[0].caps]
        out += await scenario(c, client_ns, srv, eng, coord)
        await c.close()
        await proxy.stop()
        await srv.stop()
        return (out, proxy.frames("c2s"), proxy.frames("s2c"),
                srv.stats())

    out, c2s, s2c, stats = asyncio.run(main())
    # the coordinator finishes whatever the server handed it
    hb = eng.cfg.heartbeat_period
    for _ in range(400):
        if not coord._resolves:
            break
        eng.run_for(2 * hb)
        coord.poll_all()
    stores = [sorted(d.items()) for d in skv._data]
    return (out, c2s, s2c, stats, board.compose().get("txn"), stores,
            skv.lock_stats())


def _all_pairs(scenario, **kw):
    runs = {(c.name, s.name): _session(c, s, scenario, **kw)
            for c, s in PAIRS}
    want = runs[("raft_tpu", "raft_tpu")]
    for pair, got in runs.items():
        for i, what in enumerate(("results", "client frames",
                                  "server frames", "stats", "txn section",
                                  "stores", "lock stats")):
            assert got[i] == want[i], (pair, what)
    return want


# --------------------------------------------------------- TestTxnWire
async def _commit_abort_status(c, ns, srv, eng, coord):
    P = ns.P
    out = [bool(c._conns[0].caps & P.CAP_TXN)]
    r = await c.txn_commit([(b"a", b"1"), (b"b", b"2")])
    r2 = await c.txn_commit([(b"a", b"9")], expects=[(b"a", b"0")])
    v = await c.read(b"a")
    st = await c.txn_status(r.txn_id)
    st2 = await c.txn_status(0xDEAD)
    ab = await c.txn_abort(0xBEEF)
    out += [_res(x) for x in (r, r2, st, st2, ab)] + [v.value]
    return out


def test_commit_abort_status_over_wire_all_pairings():
    out, c2s, s2c, stats, section, stores, locks = _all_pairs(
        _commit_abort_status)
    caps, has_txn, r, r2, st, st2, ab, v = out
    assert has_txn
    assert r[2] == "committed"
    assert r2[2:4] == ("aborted", "expect_failed")
    assert v == b"1"
    assert st[2] == "committed" and st2[2] == "unknown"
    assert ab[2:4] == ("aborted", "client_abort")
    assert stats["pending_txns"] == 0
    assert stats["requests_total"]["txn_commit"] == 2
    assert section["committed"] == 1 and section["aborted"] == 1
    assert section["held"] == 0 and locks["held"] == 0
    P = JX.P
    assert c2s[0][0] == P.HELLO and s2c[0][0] == P.WELCOME
    kinds = {k for k, _ in c2s}
    assert {P.TXN_BEGIN, P.TXN_COMMIT, P.TXN_STATUS,
            P.TXN_ABORT} <= kinds
    assert sum(k == P.TXN_STATE for k, _ in s2c) == 7


async def _no_coordinator(c, ns, srv, eng, coord):
    out = [bool(c._conns[0].caps & ns.P.CAP_TXN)]
    out.append(await _expect_error(ns, c.txn_commit([(b"k", b"v")])))
    out.append(await _expect_error(ns, c.txn_status(1)))
    r = await c.submit(b"k", b"v")
    out += [_res(r), bool(eng.is_durable(r.group, r.seq))]
    return out


def test_server_without_coordinator_never_speaks_cap_txn_all_pairings():
    out, c2s, s2c, stats, section, _, _ = _all_pairs(_no_coordinator,
                                                     armed=False)
    assert out[1] is False and out[-1] is True
    assert "txn_commit" not in stats["requests_total"]
    assert section is None
    assert [k for k, _ in c2s] == [JX.P.HELLO, JX.P.SUBMIT]


async def _unopted(c, ns, srv, eng, coord):
    out = [bool(c._conns[0].caps & ns.P.CAP_TXN)]
    out.append(await _expect_error(ns, c.txn_commit([(b"k", b"v")])))
    r = await c.submit(b"k", b"v")
    out += [_res(r), bool(eng.is_durable(r.group, r.seq))]
    return out


def test_unopted_client_against_txn_server_all_pairings():
    out, c2s, _, stats, section, _, _ = _all_pairs(_unopted,
                                                   client_kw={})
    assert out[1] is False and out[-1] is True
    assert [k for k, _ in c2s] == [JX.P.HELLO, JX.P.SUBMIT]
    assert section["committed"] == 0


# ----------------------------------------------- adoption by the coordinator
async def _timed_out(c, ns, srv, eng, coord):
    out = [await _expect_error(ns, c.txn_commit([(b"a", b"1"),
                                                 (b"b", b"2")]))]
    out.append(len(coord._resolves))
    # each status query is one pump iteration: one drive quantum and one
    # sweep, which polls the adopted handle to its end
    for _ in range(200):
        st = await c.txn_status(1)
        if st.status != "unknown":
            break
    out.append(_res(st))
    return out


def test_timed_out_txn_is_adopted_not_orphaned_all_pairings():
    out, _, s2c, stats, section, stores, locks = _all_pairs(
        _timed_out, op_timeout_s=1e-9, client_kw={"txn": True,
                                                  "retries": 0})
    _, err, adopted, st = out
    assert "outcome unknown" in err[1] and adopted == 1
    assert st[2] == "committed"
    assert stats["pending_txns"] == 0 and locks["held"] == 0
    assert sorted(v for s in stores for _, v in s) == [b"1", b"2"]
    assert s2c[-1][0] == JX.P.TXN_STATE


async def _pump_dies(c, ns, srv, eng, coord):
    orig = srv.backend.drive

    def drive(seconds):
        if srv._pending_txns:
            raise RuntimeError("drive died")
        orig(seconds)

    srv.backend.drive = drive
    out = [await _expect_error(ns, c.txn_commit([(b"a", b"1"),
                                                 (b"b", b"2")]))]
    out.append(len(coord._resolves))
    return out


def test_pump_crash_adopts_pending_txn_all_pairings(capsys):
    out, _, s2c, stats, section, stores, locks = _all_pairs(
        _pump_dies, client_kw={"txn": True, "retries": 0})
    _, err, adopted = out
    assert "drive died" in err[1] and adopted == 1
    assert stats["pending_txns"] == 0
    assert locks["held"] == 0 and locks["decisions"] == 1
    assert sorted(v for s in stores for _, v in s) == [b"1", b"2"]
    assert s2c[-1][0] == JX.P.ERROR
    assert "drive died" in capsys.readouterr().err
