"""Canonical-form answer cache.

The front-door subsystem that answers repeated puzzles — and their
symmetries — without touching the device:

  canonical.py  deterministic minimal-form reduction over the sudoku
                symmetry group's generators, producing a canonical key +
                an INVERTIBLE transform record (soundness comes from the
                transform, never from the reduction's completeness)
  store.py      sharded bounded LRU keyed by canonical hash; writes are
                gated on host-side rule verification (verified answers
                only), hits are de-canonicalized through the inverse
                transform and rule-checked before serving
  gossip.py     fleet convergence: top-K hot-set digests riding the stats
                heartbeat plus the cache_get/cache_answer UDP pair, so a
                local miss on a peer-advertised hot key fetches the
                answer instead of dispatching

Copies of the JAX package's modules of the same names, with equal keys.
"""

from .canonical import CanonicalForm, Transform, canonicalize
from .gossip import CacheGossip, PeerHotset
from .store import AnswerCache

__all__ = [
    "AnswerCache",
    "CacheGossip",
    "CanonicalForm",
    "PeerHotset",
    "Transform",
    "canonicalize",
]
