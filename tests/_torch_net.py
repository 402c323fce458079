"""Shared helpers of the port's wire-tier tests (tests/test_torch_net_*.py,
test_torch_wire_*.py): one namespace a package, so a scenario written once
runs through the JAX package and through the port on the CPU, the
loopback server harness of ``tests/test_net_wire.py``, and a recording
proxy that captures the frames each side of a connection sends. Not a
test module (leading underscore: pytest does not collect it)."""

from __future__ import annotations

import asyncio
import importlib
from types import SimpleNamespace

PACKAGES = ("raft_tpu", "raft_tpu_torch")


def pkg(name: str) -> SimpleNamespace:
    """The wire stack of one package. ``engine(cfg)`` and ``multi(cfg, G)``
    build the package's engines (the port's on the CPU)."""
    m = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    port = name == "raft_tpu_torch"
    cfgmod, raft = m("config"), m("raft")
    multi = m("multi.engine")

    def engine(cfg):
        if port:
            from raft_tpu_torch.transport.device import SingleDeviceTransport

            return raft.RaftEngine(cfg, SingleDeviceTransport(cfg,
                                                              device="cpu"))
        return raft.RaftEngine(cfg)

    def multi_engine(cfg, groups):
        if port:
            return multi.MultiEngine(cfg, groups, device="cpu")
        return multi.MultiEngine(cfg, groups)

    return SimpleNamespace(
        name=name, port=port, RaftConfig=cfgmod.RaftConfig, engine=engine,
        multi=multi_engine, ReplicatedKV=m("examples.kv").ReplicatedKV,
        ShardedKV=m("examples.kv_sharded").ShardedKV,
        Router=m("multi.router").Router,
        ReadSession=m("multi.router").ReadSession, net=m("net"),
        client=m("net.client"), server=m("net.server"),
        P=m("net.protocol"), SpanTracker=m("obs.spans").SpanTracker,
        MetricsRegistry=m("obs.registry").MetricsRegistry,
        PumpProfiler=m("obs.hostprof").PumpProfiler,
        StatusBoard=m("obs.serve").StatusBoard,
        runner=m("chaos.runner"),
    )


def engine_cfg(ns, **kw):
    """``tests/test_net_wire.py``'s engine config in ``ns``'s package."""
    base = dict(n_replicas=3, entry_bytes=32, batch_size=4,
                log_capacity=256, transport="single", seed=0)
    base.update(kw)
    return ns.RaftConfig(**base)


def serve(ns, backend, scenario, **server_kw):
    """Boot ``ns``'s server, run ``scenario(server, port)``, tear down."""
    async def main():
        srv = ns.net.IngestServer(backend, **server_kw)
        port = await srv.start()
        try:
            return await scenario(srv, port)
        finally:
            await srv.stop()
    return asyncio.run(main())


def reset_counters(*names) -> None:
    """Zero the class-level counters of the named packages' wire tier
    (connection ids, client trace nodes), so two runs name the same."""
    for name in names or PACKAGES:
        ns_srv = importlib.import_module(f"{name}.net.server")
        ns_cli = importlib.import_module(f"{name}.net.client")
        ns_srv._Conn._next_cid = 0
        ns_cli.WireClient._next_node = 0


class Proxy:
    """A loopback TCP proxy that records every byte each side sends.
    ``frames("c2s")`` / ``frames("s2c")`` decode them with the JAX codec."""

    def __init__(self, target_port: int):
        self.target = target_port
        self.data = {"c2s": bytearray(), "s2c": bytearray()}
        self._server = None
        self._tasks = []

    async def start(self) -> int:
        self._server = await asyncio.start_server(self._handle,
                                                  "127.0.0.1", 0)
        return self._server.sockets[0].getsockname()[1]

    async def _pipe(self, reader, writer, key):
        try:
            while True:
                data = await reader.read(1 << 16)
                if not data:
                    break
                self.data[key].extend(data)
                writer.write(data)
                await writer.drain()
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _handle(self, c_reader, c_writer):
        s_reader, s_writer = await asyncio.open_connection("127.0.0.1",
                                                           self.target)
        loop = asyncio.get_running_loop()
        self._tasks += [
            loop.create_task(self._pipe(c_reader, s_writer, "c2s")),
            loop.create_task(self._pipe(s_reader, c_writer, "s2c")),
        ]

    async def stop(self) -> None:
        self._server.close()
        await self._server.wait_closed()
        for t in self._tasks:
            t.cancel()
        await asyncio.sleep(0)

    def frames(self, key: str) -> list:
        from raft_tpu.net import protocol as P

        return P.FrameDecoder().feed(bytes(self.data[key]))
