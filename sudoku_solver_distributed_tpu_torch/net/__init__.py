"""Networking: wire protocol, membership, stats gossip, the node, the HTTP
API and its two transports, the reference's ``SudokuSolver`` surface and
the CLI."""

from .wire import Msg, encode_msg, decode_msg, parse_address
from .stats import StatsGossip
from .membership import Membership
from .node import P2PNode
from .http_api import make_http_server
from .fastserve import FastHTTPServer
from .solver_api import SudokuSolver

__all__ = [
    "Msg",
    "encode_msg",
    "decode_msg",
    "parse_address",
    "StatsGossip",
    "Membership",
    "P2PNode",
    "make_http_server",
    "FastHTTPServer",
    "SudokuSolver",
]
