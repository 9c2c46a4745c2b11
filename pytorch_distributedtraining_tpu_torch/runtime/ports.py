"""A free TCP port, for a rendezvous or a membership server on one host.

Stdlib only: the launcher (``runtime/launch.py``), which must not import
torch, picks each generation's port with it; ``runtime.dist`` re-exports
it for everyone else.
"""

from __future__ import annotations

import socket


def find_free_port() -> int:
    """A free TCP port on localhost, for a single-host rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
