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

Copies of the JAX package's modules of the same names, with equal keys.
Not here yet: ``gossip.py`` (``CacheGossip``, ``PeerHotset`` — the hot-set
digest on the stats heartbeat and the ``cache_get``/``cache_answer`` UDP
pair). It needs the peer map and the UDP event loop, which come with the
P2P slice; until then a node's cache answers only what it solved itself.
"""

from .canonical import CanonicalForm, Transform, canonicalize
from .store import AnswerCache

__all__ = [
    "AnswerCache",
    "CanonicalForm",
    "Transform",
    "canonicalize",
]
