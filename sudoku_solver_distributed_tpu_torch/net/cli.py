"""Node CLI — the port's counterpart of ``sudoku_solver_distributed_tpu/net/cli.py``.

    python -m sudoku_solver_distributed_tpu_torch.net.cli -p 8001 -s 7001 -h 1

The reference's flags, with the same meanings and defaults:
  -p  HTTP port (default 8001)
  -s  P2P/UDP port (default 7000)
  -a  anchor node "host:port" — joining a network comes with the P2P slice;
      this port exits with a message when it is given
  -h  handicap in ms, divided by 100 into base_delay seconds (the
      reference's conversion); -h means handicap, not help, as in the
      reference
Extensions:
  --host        bind address (default 127.0.0.1)
  --buckets     comma-separated engine batch widths
  --platform    gpu (default: the DFS kernel on the CUDA device) or cpu (the
                plain PyTorch solver); gpu with no CUDA device fails
  --no-warmup   skip the warm-up pass over every bucket width
"""

from __future__ import annotations

import argparse
import logging
import threading

from ..engine import SolverEngine
from .http_api import make_http_server
from .node import P2PNode

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Sudoku Solver Node (PyTorch/CUDA)",
        conflict_handler="resolve",
    )
    parser.add_argument("-p", type=int, default=8001, help="HTTP port")
    parser.add_argument("-s", type=int, default=7000, help="P2P port")
    parser.add_argument("-a", help="Anchor node address (host:port)")
    parser.add_argument(
        "-h", type=float, default=1, help="Handicap (delay in ms) for validation"
    )
    parser.add_argument("--host", default="127.0.0.1", help="bind address")
    parser.add_argument(
        "--buckets", default=None, help="comma-separated batch bucket widths"
    )
    parser.add_argument(
        "--platform",
        default="gpu",
        choices=["gpu", "cpu"],
        help="run the solver on the CUDA device (default) or the CPU",
    )
    parser.add_argument("--no-warmup", action="store_true")
    return parser


def build_node(args: argparse.Namespace):
    """Construct the engine (warmed unless --no-warmup), the node and its
    HTTP server from parsed CLI arguments. Returns (node, httpd); the
    caller starts ``httpd.serve_forever`` and ``node.run``."""
    kwargs = {"device": "cuda" if args.platform == "gpu" else "cpu"}
    if args.buckets:
        kwargs["buckets"] = tuple(int(b) for b in args.buckets.split(","))
    engine = SolverEngine(**kwargs)
    if not args.no_warmup:
        engine.warmup()
    node = P2PNode(args.host, args.s, handicap=args.h / 100, engine=engine)
    httpd = make_http_server(node, args.host, args.p)
    return node, httpd


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.a:
        parser.exit(
            2,
            "joining a network (-a) is not ported yet: it comes with the "
            "P2P slice; start a single node without -a\n",
        )
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s - %(levelname)s - %(message)s"
    )
    node, httpd = build_node(args)
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    try:
        node.run()
    except KeyboardInterrupt:
        node.shutdown()
    finally:
        httpd.shutdown()
        httpd.server_close()


if __name__ == "__main__":
    main()
