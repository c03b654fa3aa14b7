"""Connection helpers.

The port's own copy of ``close_quietly`` from
``fluentbit_tpu/core/upstream.py`` (reference src/flb_upstream.c). The
pools, HA node sets and the DNS cache wait for the port's outputs that
dial out.
"""

from __future__ import annotations


def close_quietly(writer) -> None:
    """Best-effort transport teardown for every socket error and exit
    path. ``StreamWriter.close()`` raises ``OSError`` on an already dead
    transport and ``RuntimeError`` on a closed owning loop; both mean
    there is nothing left to close. Anything else propagates."""
    try:
        writer.close()
    except (OSError, RuntimeError):
        pass
