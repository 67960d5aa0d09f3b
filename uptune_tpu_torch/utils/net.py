"""Small shared networking guards (no repo-internal imports, so both
the serve client and the telemetry shipper can use them without
coupling the planes)."""
from __future__ import annotations

import socket


def reject_self_connect(sock: socket.socket, label: str) -> None:
    """Close and refuse a TCP self-connection.

    Dialing a DOWN localhost port in the ephemeral range can land the
    client's own local port on the target and connect the socket to
    itself (the TCP simultaneous-open quirk): the "connection" answers
    nothing and, worse, HOLDS the port against the very server restart
    a resuming client is waiting for.  Callers invoke this right after
    ``create_connection``; it raises ``ConnectionRefusedError`` (an
    OSError, so every reconnect-with-backoff loop treats it like any
    refused dial)."""
    if sock.getsockname() == sock.getpeername():
        try:
            sock.close()
        except OSError:
            pass
        raise ConnectionRefusedError(
            f"self-connection to {label} (peer down)")
