"""Peer-tier authentication: shared token now, TLS as a seam (port of
``raft_tpu/cluster/auth.py``).

The wire tier was built for loopback benches; a peer plane that accepts
``PEER_HELLO`` from anyone would let any process that can reach the
port vote in elections. The deployment story (docs/CLUSTER.md) is:

- **Token** — every ``PEER_HELLO`` carries the cluster's shared secret;
  the receiving server verifies it BEFORE any other peer frame is
  honored on the connection. A mismatch raises :class:`PeerAuthError`
  (a ``ProtocolError``), which the server's frame loop answers with a
  connection-level ERROR and a close — same teardown as a corrupt
  frame, so an unauthenticated prober learns nothing but "closed".
  Comparison is constant-time (``hmac.compare_digest``).
- **TLS** — :meth:`ClusterAuth.server_ssl` / :meth:`ClusterAuth.
  client_ssl` return ``ssl.SSLContext`` objects when cert/key paths are
  configured, ``None`` otherwise; the child entrypoint passes them to
  ``asyncio``'s server/connection factories. The default deployment
  (loopback CI) runs tokens-only; the hook exists so a real deployment
  terminates TLS without touching the frame layer.
"""

from __future__ import annotations

import hmac
from typing import Optional

from raft_tpu_torch.net.protocol import ProtocolError


class PeerAuthError(ProtocolError):
    """PEER_HELLO token mismatch — the stream is closed unauthenticated."""


class ClusterAuth:
    def __init__(self, token: bytes = b"",
                 certfile: Optional[str] = None,
                 keyfile: Optional[str] = None,
                 cafile: Optional[str] = None):
        self.token = bytes(token)
        self.certfile = certfile
        self.keyfile = keyfile
        self.cafile = cafile

    def verify(self, token: bytes) -> None:
        if not hmac.compare_digest(self.token, bytes(token)):
            raise PeerAuthError("peer token mismatch")

    # ------------------------------------------------------- TLS seam
    def server_ssl(self):
        if not self.certfile:
            return None
        import ssl

        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.certfile, self.keyfile)
        if self.cafile:
            ctx.load_verify_locations(self.cafile)
            ctx.verify_mode = ssl.CERT_REQUIRED
        return ctx

    def client_ssl(self):
        if not self.certfile:
            return None
        import ssl

        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        if self.cafile:
            ctx.load_verify_locations(self.cafile)
        ctx.load_cert_chain(self.certfile, self.keyfile)
        return ctx
