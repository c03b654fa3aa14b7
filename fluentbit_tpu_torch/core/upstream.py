"""Name resolution, HA node sets and connection helpers.

The port's own copy of ``fluentbit_tpu/core/upstream.py`` (reference
src/flb_upstream_ha.c, flb_upstream_node.c and the c-ares role of
src/flb_net_dns.h):

- :func:`resolve`, every address of a host in ``getaddrinfo`` order,
  behind a DNS cache with a TTL, and :func:`invalidate_dns`;
- :class:`UpstreamNode` and :class:`UpstreamHA`, a weighted node set
  with failover (smooth weighted round-robin over the nodes whose
  circuit breaker would admit a request), and
  :func:`parse_upstream_file`, which loads one from an upstream file of
  ``[UPSTREAM]`` and ``[NODE]`` sections;
- :func:`close_quietly`, the close of every socket error and exit path.

The keep-alive pool (the reference's ``Upstream``) serves the HTTP
outputs, which are not ported: the ``net.keepalive*`` keys raise.
"""

from __future__ import annotations

import ipaddress
import socket
import time
from typing import List, Optional

from .guard import CircuitBreaker

#: (host, port) → (addresses, expiry); mutated in place, never rebound
_dns_cache: dict = {}
_DNS_TTL = 30.0
_DNS_CACHE_MAX = 512


def close_quietly(writer) -> None:
    """Best-effort transport teardown for every socket error and exit
    path. ``StreamWriter.close()`` raises ``OSError`` on an already dead
    transport and ``RuntimeError`` on a closed owning loop; both mean
    there is nothing left to close. Anything else propagates."""
    try:
        writer.close()
    except (OSError, RuntimeError):
        pass


async def resolve(host: str, port: int) -> List[str]:
    """Every resolved address of ``host``, in ``getaddrinfo`` order (a
    literal address passes through as the only entry). Callers keep the
    multi-address connect fallback: one address would break dual-stack
    and multi-A-record destinations."""
    import asyncio

    try:
        ipaddress.ip_address(host)
        return [host]
    except ValueError:
        pass
    now = time.time()
    hit = _dns_cache.get((host, port))
    if hit is not None and hit[1] > now:
        return hit[0]
    loop = asyncio.get_running_loop()
    infos = await loop.getaddrinfo(host, port, type=socket.SOCK_STREAM)
    addrs: List[str] = []
    for info in infos:
        a = info[4][0]
        if a not in addrs:
            addrs.append(a)
    _dns_cache[(host, port)] = (addrs, now + _DNS_TTL)
    if len(_dns_cache) > _DNS_CACHE_MAX:
        # evict the soonest-expiring entries (an expired-only sweep
        # removes nothing when every entry is live)
        for k in sorted(_dns_cache, key=lambda k: _dns_cache[k][1])[
                : len(_dns_cache) - _DNS_CACHE_MAX]:
            _dns_cache.pop(k, None)
    return addrs


def invalidate_dns(host: str, port: int) -> None:
    _dns_cache.pop((host, port), None)


class UpstreamNode:
    __slots__ = ("name", "host", "port", "weight", "properties",
                 "breaker")

    def __init__(self, name: str, host: str, port: int,
                 weight: int = 1, properties=None):
        self.name = name
        self.host = host
        self.port = port
        self.weight = max(1, int(weight))
        self.properties = properties or {}
        # a node's health is a circuit breaker: one failure opens it for
        # the set's retry_window, available() re-admits it for a probe,
        # mark_up closes it
        self.breaker = CircuitBreaker(name, failures=1, cooldown=10.0)


class UpstreamHA:
    """Weighted node set with failover (flb_upstream_ha.c).

    ``pick()`` is smooth weighted round-robin over the nodes whose
    breaker would admit a request; ``mark_down(node)`` records a failure
    (one opens the node's breaker for ``retry_window`` seconds),
    ``mark_up(node)`` closes it. When every node is down the pick goes
    over all of them, and the caller surfaces the delivery error."""

    def __init__(self, name: str, nodes: List[UpstreamNode],
                 retry_window: float = 10.0):
        self.name = name
        self.nodes = nodes
        self.retry_window = retry_window
        for n in nodes:
            n.breaker.cooldown = retry_window
        self._current = {n.name: 0 for n in nodes}

    def pick(self) -> Optional[UpstreamNode]:
        if not self.nodes:
            return None
        candidates = [n for n in self.nodes if n.breaker.available()]
        if not candidates:
            candidates = self.nodes  # all down: let the caller fail
        total = sum(n.weight for n in candidates)
        best = None
        for n in candidates:
            self._current[n.name] += n.weight
            if best is None or self._current[n.name] > \
                    self._current[best.name]:
                best = n
        self._current[best.name] -= total
        return best

    def mark_down(self, node: UpstreamNode) -> None:
        node.breaker.record_failure()

    def mark_up(self, node: UpstreamNode) -> None:
        node.breaker.reset()


def parse_upstream_file(path: str) -> UpstreamHA:
    """Load an upstream definition file: classic-INI ``[UPSTREAM]`` with
    ``name``, then ``[NODE]`` sections with name, host, port, weight and
    any other per-node properties (flb_upstream_node.c)."""
    from ..config_format import parse_classic

    with open(path) as f:
        cf = parse_classic(f.read())
    name = "upstream"
    nodes: List[UpstreamNode] = []
    for sec in cf.sections:
        if sec.name.lower() == "upstream":
            name = sec.get("name", name)
        elif sec.name.lower() == "node":
            props = {k.lower(): v for k, v in sec.properties}
            nodes.append(UpstreamNode(
                props.get("name", f"node{len(nodes)}"),
                props.get("host", "127.0.0.1"),
                int(props.get("port", 24224)),
                int(props.get("weight", 1)),
                props,
            ))
    if not nodes:
        raise ValueError(f"upstream file {path!r} defines no nodes")
    return UpstreamHA(name, nodes)
