"""UDP wire protocol: the reference's 7 JSON message types, byte-identical.

A copy of ``sudoku_solver_distributed_tpu/net/wire.py``: the port imports
nothing from the JAX package, and its bodies must stay byte-identical.

Message constructors pin the exact field *order* the reference emits (JSON
object key order is insertion order under json.dumps), so a capture of this
node's traffic is indistinguishable from the reference's:

  connect     {"type", "address"}                      reference node.py:563
  connected   {"type", "address"}                      reference node.py:199
  all_peers   {"type", "all_peers"}                    reference node.py:573
  disconnect  {"type", "address"[, "row", "col"]}      reference node.py:652-654
  solve       {"type", "sudoku", "row", "col", "address"[, "trace"]
               [, "hedge"]}                           reference node.py:441
              ("hedge" marks a tail-at-scale duplicate dispatch —
              serving/autopilot.py; absent on primary
              dispatches, keeping default traffic byte-identical)
  solution    {"type", "sudoku", "col", "row", "solution", "address"
               [, "trace"]}
              (note: "col" BEFORE "row" — the reference really does emit this
              order, node.py:402; "trace" is this stack's optional
              request-trace-id piggyback — absent unless the dispatching
              master carried a traced request, keeping default traffic
              byte-identical, same trailing-optional pattern as
              disconnect's row/col and stats' health)
  stats       {"type", "origin", "solved", "stats": {"address", "validations"},
               "all_stats"[, "health"][, "telemetry"][, "hotset"]}
              reference node.py:583-592
              ("health" is this stack's optional supervisor-state
              piggyback — absent unless an EngineSupervisor is attached;
              "telemetry" is the optional fleet-observability digest
              (obs/cluster.py) — absent unless the tracing
              plane publishes one; "hotset" is the optional answer-cache
              hot-set digest (cache/gossip.py) — absent unless
              a cache holds entries; all trailing, keeping default
              traffic byte-identical)

Extension pair (this stack only, not reference surfaces):

  cache_get    {"type", "hash", "address"}
  cache_answer {"type", "hash", "board", "solution", "address"}
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional, Tuple

Msg = Dict[str, Any]

# Wire cap: the reference reads 1024-byte datagrams (node.py:183) which is a
# scaling cliff for big boards/member lists; we speak the same protocol but
# read up to 64 KiB (a 25×25 solve message is ~2.6 KB). Datagrams we *send*
# that exceed the reference's buffer would be truncated by a reference
# receiver, so interop with actual reference nodes holds for 9×9 traffic.
RECV_BUFFER = 65536


def parse_address(address: str) -> Tuple[str, int]:
    """"host:port" → (host, port)."""
    host, port = address.rsplit(":", 1)
    return host, int(port)


def valid_address(address) -> bool:
    """True iff ``address`` is a "host:port" string that parse_address AND
    a UDP sendto will both accept.

    The ingress guard for every address-bearing field: a hostile datagram
    whose address is a float/None/garbage string must be rejected at the
    boundary — once such a value enters the membership sets, every
    periodic path that walks neighbors (gossip, anti-entropy, deletion
    relays) crashes on it each iteration BEFORE reaching recv, leaving
    the node permanently deaf (found by tests/test_wire_fuzz.py).
    Validation IS the parse (plus the 0-65535 sendto range): a separate
    reimplementation accepted Unicode digits like "²" (isdigit() is True,
    int() raises) and out-of-range ports (sendto raises OverflowError) —
    both recreated the deafness bug past the guard."""
    if not isinstance(address, str):
        return False
    try:
        host, port = parse_address(address)
    except (ValueError, TypeError):
        return False
    return bool(host) and 0 <= port <= 65535


_LOOPBACK_NAMES = {"localhost", "localhost.localdomain", "ip6-localhost"}


def canonical_host(host: str) -> str:
    """Normalize a host for identity comparison (goodbye-vs-rumor
    discrimination, net/node.py): every loopback alias — "localhost", any
    127.0.0.0/8 literal, "::1" — maps to "127.0.0.1", so a node bound to
    "localhost" whose datagrams arrive from "127.0.0.1" (or 127.0.1.1,
    Debian's /etc/hosts quirk) compares equal to itself. Non-loopback
    hosts are case-folded only: resolving arbitrary names here would put
    a blocking DNS lookup on the UDP receive path."""
    h = host.strip().lower()
    if h in _LOOPBACK_NAMES or h == "::1":
        return "127.0.0.1"
    if h.startswith("127."):
        parts = h.split(".")
        if len(parts) == 4 and all(p.isascii() and p.isdigit() for p in parts):
            return "127.0.0.1"
    return h


def is_ip_literal(host: str) -> bool:
    """A dotted-quad IPv4 or bracketless IPv6 literal (something a UDP
    source address could ever equal byte-for-byte)."""
    if ":" in host:
        return True  # IPv6 literal shape; hostnames can't contain ':'
    parts = host.split(".")
    return len(parts) == 4 and all(
        p.isascii() and p.isdigit() and int(p) <= 255 for p in parts
    )


def same_endpoint(source: Tuple[str, int], announced: Tuple[str, int]) -> bool:
    """Does a datagram's UDP ``source`` plausibly belong to the
    ``announced`` "host:port" identity? The goodbye-vs-rumor test
    (net/node.py).

    When the announced host is an IP literal (after loopback/alias
    normalization — the normal deployment shape, and the only one where
    same-port multi-host rumor confusion can arise), the comparison is
    strict (host, port). When a node announced itself by HOSTNAME, its
    datagrams arrive from an IP we cannot compare without putting a DNS
    lookup on the UDP receive path — fall back to the port-only
    heuristic (the pre-PR-2 behavior) rather than misread every such
    node's own goodbye as a rumor."""
    if source[1] != announced[1]:
        return False
    ann = canonical_host(announced[0])
    if not is_ip_literal(ann):
        return True  # hostname identity: port match is the best we have
    return canonical_host(source[0]) == ann


def encode_msg(msg: Msg) -> bytes:
    return json.dumps(msg).encode()


def decode_msg(payload: bytes) -> Msg:
    return json.loads(payload.decode())


# -- constructors (field order = reference emission order) ------------------

def connect_msg(self_address: str) -> Msg:
    return {"type": "connect", "address": self_address}


def connected_msg(self_address: str) -> Msg:
    return {"type": "connected", "address": self_address}


def all_peers_msg(all_peers: Dict[str, list]) -> Msg:
    return {"type": "all_peers", "all_peers": all_peers}


def disconnect_msg(self_address: str, task: Optional[Tuple[int, int]] = None) -> Msg:
    if task is None:
        return {"type": "disconnect", "address": self_address}
    return {
        "type": "disconnect",
        "address": self_address,
        "row": task[0],
        "col": task[1],
    }


def solve_msg(
    sudoku,
    row: int,
    col: int,
    self_address: str,
    trace: Optional[str] = None,
    hedge: bool = False,
) -> Msg:
    # ``trace`` piggybacks the originating request's trace id (obs/trace.py)
    # on the task dispatch so a worker's farmed-cell span — and the
    # solution it sends back — can be correlated with the master's request
    # timeline across nodes. ``hedge`` marks a tail-at-scale duplicate
    # dispatch (serving/autopilot.py): the master has already
    # dispatched this cell to another peer and is racing the straggler —
    # workers count the flag (net/node.py) so a chaos run's hedge volume
    # is observable on BOTH ends of the wire. Each optional-and-trailing
    # like disconnect's row/col: absent by default, so the default wire
    # bytes stay identical to the reference's; four explicit literals
    # keep every variant visible to analysis/wire_schema.py.
    if not hedge:
        if trace is None:
            return {
                "type": "solve",
                "sudoku": sudoku,
                "row": row,
                "col": col,
                "address": self_address,
            }
        return {
            "type": "solve",
            "sudoku": sudoku,
            "row": row,
            "col": col,
            "address": self_address,
            "trace": trace,
        }
    if trace is None:
        return {
            "type": "solve",
            "sudoku": sudoku,
            "row": row,
            "col": col,
            "address": self_address,
            "hedge": True,
        }
    return {
        "type": "solve",
        "sudoku": sudoku,
        "row": row,
        "col": col,
        "address": self_address,
        "trace": trace,
        "hedge": True,
    }


def solution_msg(
    sudoku,
    row: int,
    col: int,
    solution,
    self_address: str,
    trace: Optional[str] = None,
) -> Msg:
    # the worker echoes the dispatch's trace id back (same optionality),
    # closing the cross-node correlation loop master-side
    if trace is None:
        return {
            "type": "solution",
            "sudoku": sudoku,
            "col": col,
            "row": row,
            "solution": solution,
            "address": self_address,
        }
    return {
        "type": "solution",
        "sudoku": sudoku,
        "col": col,
        "row": row,
        "solution": solution,
        "address": self_address,
        "trace": trace,
    }


def stats_msg(
    origin: str,
    solved: int,
    validations: int,
    all_stats: Msg,
    health: Optional[str] = None,
    telemetry: Optional[Msg] = None,
    hotset: Optional[Msg] = None,
) -> Msg:
    # ``health`` piggybacks the sender's engine-supervisor state
    # (serving/health.py: "warming"/"healthy"/"degraded"/"lost") on the
    # existing 1 Hz stats heartbeat so masters can skip LOST peers when
    # farming tasks (net/node.py). ``telemetry`` piggybacks the sender's
    # fleet-observability digest (obs/cluster.py: goodput, stage
    # latencies, shed rate, warm fraction, mesh topology) on
    # the same heartbeat so any node can render GET /metrics/cluster.
    # ``hotset`` piggybacks the sender's answer-cache hot-set digest
    # (cache/gossip.py: top-K canonical hashes + hit counts)
    # so peers learn which keys a cache_get to this node would answer.
    # All optional-and-trailing like disconnect's row/col — absent keys
    # keep the default wire bytes identical to the reference's, and the
    # eight explicit literals keep every variant visible to
    # analysis/wire_schema.py (a mutated dict would hide the schema).
    if hotset is None:
        if health is None and telemetry is None:
            return {
                "type": "stats",
                "origin": origin,
                "solved": solved,
                "stats": {"address": origin, "validations": validations},
                "all_stats": all_stats,
            }
        if telemetry is None:
            return {
                "type": "stats",
                "origin": origin,
                "solved": solved,
                "stats": {"address": origin, "validations": validations},
                "all_stats": all_stats,
                "health": health,
            }
        if health is None:
            return {
                "type": "stats",
                "origin": origin,
                "solved": solved,
                "stats": {"address": origin, "validations": validations},
                "all_stats": all_stats,
                "telemetry": telemetry,
            }
        return {
            "type": "stats",
            "origin": origin,
            "solved": solved,
            "stats": {"address": origin, "validations": validations},
            "all_stats": all_stats,
            "health": health,
            "telemetry": telemetry,
        }
    if health is None and telemetry is None:
        return {
            "type": "stats",
            "origin": origin,
            "solved": solved,
            "stats": {"address": origin, "validations": validations},
            "all_stats": all_stats,
            "hotset": hotset,
        }
    if telemetry is None:
        return {
            "type": "stats",
            "origin": origin,
            "solved": solved,
            "stats": {"address": origin, "validations": validations},
            "all_stats": all_stats,
            "health": health,
            "hotset": hotset,
        }
    if health is None:
        return {
            "type": "stats",
            "origin": origin,
            "solved": solved,
            "stats": {"address": origin, "validations": validations},
            "all_stats": all_stats,
            "telemetry": telemetry,
            "hotset": hotset,
        }
    return {
        "type": "stats",
        "origin": origin,
        "solved": solved,
        "stats": {"address": origin, "validations": validations},
        "all_stats": all_stats,
        "health": health,
        "telemetry": telemetry,
        "hotset": hotset,
    }


def cache_get_msg(key_hash: str, self_address: str) -> Msg:
    # answer-cache peer fetch (cache/gossip.py): a node that
    # missed locally on a canonical key a fresh peer's hot-set digest
    # advertises asks that peer directly; the peer replies with
    # cache_answer (or stays silent — the sender's bounded wait is the
    # negative reply, so spoofed gets cannot be amplified into floods)
    return {"type": "cache_get", "hash": key_hash, "address": self_address}


def cache_answer_msg(
    key_hash: str, board, solution, self_address: str
) -> Msg:
    # the fetch reply: the CANONICAL (board, solution) pair for the
    # requested key. Receivers never trust the claimed hash — the pair
    # is re-canonicalized and rule-verified through the store's write
    # gate on arrival (cache/store.py store_canonical), so a hostile
    # answer is dropped and counted, never served or cached.
    return {
        "type": "cache_answer",
        "hash": key_hash,
        "board": board,
        "solution": solution,
        "address": self_address,
    }
