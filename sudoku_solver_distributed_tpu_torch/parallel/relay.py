"""The race's early exit across hosts: a relay of solve posts between the
hosts of the multi-host serving loop.

The JAX package's race across hosts stops every device on every host at
the first solve: its loop condition and body ``psum`` one scalar over the
global ``data`` axis at every step. The port's race runs a host's shards
in one launch that polls a stop word in device memory, which another
host's solve cannot reach. ``RaceRelay`` carries it there: a thread on
every host that lives with the serving loop and, for the race under way
(``begin`` .. ``finish``, one at a time):

  * reads this host's posts: the kernel writes [race, step] into the
    outbox, a 64-bit word of page-locked host memory mapped into the
    device, when a solve lowers its stop word (on the CPU the plain race
    posts through ``RaceLink.post``); a step lower than any it sent goes
    to every other host, one datagram ``b"<race>:<step>"`` each;
  * receives the other hosts' datagrams, waiting on its socket between
    two reads of the outbox: a post of this race is delivered, one of a
    later race (a host already ahead) kept for it, one of an earlier race
    dropped, and one from an address that is no other host's relay
    ignored;
  * delivers another host's step into this host's inbox: on CUDA a 64-bit
    word [race, step] of page-locked host memory mapped into every device
    (one store from this thread, no copy and no CUDA call), which the
    shards' blocks read in turns, about once every 8 steps between them,
    and honour only for their own race; on the CPU the link's ``remote``
    step, which the plain race polls once a step.

The thread serves a race on a card in the library
(``dfs_race_relay_serve``, without the interpreter's lock, in rounds of
``RELAY_ROUND_US``). Until the launch (seeding is most of a raced
request) it blocks on its socket and a wake pipe, and writes a peer's post
of this race into the inbox as it lands. From the launch until every
shard's end event has completed it spins: it reads the outbox with a
pause between two reads and the socket every 16 reads, sends a post and
writes a peer's post there, and hands any other datagram back. Nothing on
that path waits for the interpreter's lock or sleeps: on an H100 host a
timed sleep of 100 µs lasted about 1 ms, and a thread back from a system
call waited up to milliseconds for the lock. A plain race's thread blocks
on its socket and the wake pipe, which a post, the race's end and
``finish`` write to.

The mapped words carry the race's ``tag``, unique in the process (every
loop numbers its races from 1, but the words serve every loop of the
process), so a word of an earlier race, of any loop, never stops this one;
datagrams carry the race's identity, the same on every host.

Each host's relay address (a UDP socket on the address its connection to
the process group's store leaves from) is published in that store when
the relay starts. A relayed step is a real solve's step, so at least the
race's t*: the fold over every host's gathered records stays exact however
late it lands, or if it never does. The relay is quiet once this host's
race has ended (every shard's search is done, before the gather reads the
records), and delivers nothing for a race after ``finish``. A relay that
cannot send, receive or find the other hosts is logged, counted and
reported by ``health()``: the race then runs on without the other hosts'
posts (never a stop of its own making), and the gather's timeout stays the
arbiter of a host that died. A datagram that never lands (dropped, or
filtered on the way) leaves no error on either side, so ``finish`` is told
whether another host solved the race (the gathered records say so): if
none of that host's posts of it came, within ``RELAY_LATE_S`` after this
host's race ended, the race is counted ``missed`` and logged.
"""

from __future__ import annotations

import ctypes
import itertools
import logging
import os
import select
import socket
import threading
import time
from typing import Optional

logger = logging.getLogger(__name__)

# a step no solve posted (the kernels' kNoKey)
RELAY_IDLE = 0xFFFFFFFF
# an outbox with no post of any race
_OUTBOX_IDLE = 0xFFFFFFFFFFFFFFFF
# a round of the thread's service of a race: it looks at its link between
# two (a round ends early once the race has ended or the link is closed)
RELAY_ROUND_US = 10000
# how long ``finish`` waits for the thread to leave a race
RELAY_FINISH_S = 5.0
# how long the thread waits for the other hosts to publish their addresses
RELAY_RESOLVE_S = 30.0
# how long ``finish`` waits for a post of a race that another host solved,
# when none came while the race ran here
RELAY_LATE_S = 0.25
# the most shard end events a race on a card hands the library
_MAX_ENDS = 64


def relay_channel(prefix: str = "race-relay") -> tuple:
    """Where the relays of one serving loop meet: the default process
    group's store under ``prefix`` (one a loop: each loop numbers its
    races from 1), and the address this host's relay takes, the one its
    connection to the store's server leaves from (loopback when the store
    is not a TCP store). Every rank calls it alike."""
    import torch.distributed as dist

    base = dist.distributed_c10d._get_default_store()
    store, host = base, "127.0.0.1"
    while hasattr(store, "underlying_store"):
        store = store.underlying_store
    if isinstance(store, dist.TCPStore):
        family, _, _, _, server = socket.getaddrinfo(store.host, store.port,
                                                     type=socket.SOCK_DGRAM)[0]
        with socket.socket(family, socket.SOCK_DGRAM) as probe:
            probe.connect(server)  # a route, no packet
            host = probe.getsockname()[0]
    return dist.PrefixStore(prefix, base), host


def _parse(data: bytes) -> tuple:
    race, step = data.decode().split(":")
    return int(race), int(step)


def _sockaddr(family: int, host: str, port: int) -> bytes:
    """``(host, port)`` as the C ``sockaddr_in`` / ``sockaddr_in6`` that
    ``recvfrom`` fills in for a datagram from it (Linux layout)."""
    head = family.to_bytes(2, "little") + port.to_bytes(2, "big")
    if family == socket.AF_INET:
        return head + socket.inet_pton(family, host) + bytes(8)
    return head + bytes(4) + socket.inet_pton(family, host) + bytes(4)


_TAGS = itertools.count(1)  # the process's race tags (RaceLink.tag)


class RaceLink:
    """One race's end of the relay, ``race`` its identity (the serving
    loop's request id, the same on every host). Made by ``RaceRelay.begin``
    on the loop thread and handed to the race (``race_on_mesh(...,
    relay=)``):

    * the plain race polls ``stop_step()`` once a step (the least step
      posted on this host or relayed from another, None before any) and
      ``post``s a shard's solve step;
    * the kernel gets ``inbox`` and ``outbox`` (device addresses), which
      also tell the thread that the race is launched;
    * ``local_done(ends)`` says when this host's race ends: at once (the
      plain race returned), or when every CUDA event in ``ends`` has."""

    def __init__(self, relay: "RaceRelay", race: int, card: bool = False):
        self.race = int(race)
        self.tag = next(_TAGS) & 0x7FFFFFFF  # the race in this process's mapped words
        self.card = card          # the race runs on a card: the library serves it
        self._relay = relay
        self.local = RELAY_IDLE   # the least step this host posted (plain race)
        self.remote = RELAY_IDLE  # the least step another host posted
        self.heard = False        # a post of this race came from another host
        self._ends: Optional[list] = None
        self._done = threading.Event()
        self.closed = False       # finish() ran: the relay delivers nothing more
        # the same, the launch, and the shards' end events, for the library
        self._closed = ctypes.c_int(0)
        self._launched = ctypes.c_int(0)
        self._c_ends = (ctypes.c_void_p * _MAX_ENDS)()
        self._n_ends = ctypes.c_int(0)
        self.picked = False       # the thread took this race up
        self.quiet = threading.Event()  # the thread has left this race
        self.failed: Optional[str] = None
        # diagnostics (host monotonic ns; one clock for every process of
        # a host): when the thread took the race up and left it, and its
        # rounds; when it saw this host's first post and when it had sent
        # it; when it received another host's first post and when it had
        # written it into the inbox
        self.picked_ns: Optional[int] = None
        self.left_ns: Optional[int] = None
        self.polls = 0
        self.sent_step: Optional[int] = None
        self.sent_ns: Optional[int] = None
        self.posted_ns: Optional[int] = None
        self.received_step: Optional[int] = None
        self.received_ns: Optional[int] = None
        self.delivered_ns: Optional[int] = None

    # -- the plain race's side ------------------------------------------
    def stop_step(self) -> Optional[int]:
        step = min(self.local, self.remote)
        return None if step == RELAY_IDLE else step

    def post(self, step: int) -> None:
        self.local = min(self.local, int(step))
        self._relay.poke()

    # -- the kernel's side ----------------------------------------------
    @property
    def inbox(self) -> int:
        """The inbox's device address, for this race's launch."""
        return self._relay.words(self)[0] + 8

    @property
    def outbox(self) -> int:
        """The outbox's device address for this race's launch, set idle
        first (the process's one outbox may hold a post of an earlier race
        of the same identity, another loop's; no launch of an earlier race
        runs now), and the inbox given a step relayed before it."""
        return self._relay.words(self)[0]

    def local_done(self, ends=None) -> None:
        """This host's race ends when every event in ``ends`` has (None:
        it has ended)."""
        if ends is None:
            self._done.set()
        else:
            ends = list(ends)
            if len(ends) > _MAX_ENDS:
                raise ValueError(f"a race hands the relay at most {_MAX_ENDS} end events")
            self._ends = ends
            for k, end in enumerate(ends):
                self._c_ends[k] = end.cuda_event
            self._n_ends.value = len(ends)  # after the handles: the library reads it first
        self._relay.poke()

    def ended(self) -> bool:
        if self._done.is_set():
            return True
        ends = self._ends
        if ends is not None and all(e.query() for e in ends):
            self._done.set()
        return self._done.is_set()

    def close(self) -> None:
        """The race is over on this host: the relay delivers nothing more
        for it."""
        self.closed = True
        self._closed.value = 1
        self._done.set()
        self._relay.poke()

    def summary(self) -> dict:
        return {"race": self.race, "picked_ns": self.picked_ns, "left_ns": self.left_ns,
                "polls": self.polls, "sent_step": self.sent_step, "sent_ns": self.sent_ns,
                "posted_ns": self.posted_ns, "received_step": self.received_step,
                "received_ns": self.received_ns, "delivered_ns": self.delivered_ns,
                "heard": self.heard, "failed": self.failed}


class RaceRelay:
    """The relay thread of one host of a ``world``-host serving loop
    (``rank`` this host's): its datagram socket on ``host``, its address
    and the other hosts' met through ``store`` (``relay_channel()``, or any
    c10d store every rank shares, e.g. a ``HashStore`` in one process).
    ``start`` once, ``begin``/``finish`` around each race on the loop
    thread, ``stop`` at shutdown."""

    def __init__(self, store, rank: int, world: int, *, host: str = "127.0.0.1"):
        self.store = store
        self.rank = rank
        self.world = world
        self.host = host
        self.address: Optional[tuple] = None
        self._sock: Optional[socket.socket] = None
        self._pipe: Optional[tuple] = None  # the thread's wake pipe (read, write)
        self._peers: Optional[tuple] = None  # the other hosts' relay addresses
        self._early: dict = {}  # race -> least step received before it began
        self._link: Optional[RaceLink] = None
        self._wake = threading.Event()
        self._stopping = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._host: Optional[int] = None  # the relay words' host address, once on a card
        self._peer_addrs = b""  # the peers as C socket addresses, for the library
        self._c = None  # the library call's out-parameters
        self.last: Optional[dict] = None
        self.races = 0
        self.posts_sent = 0
        self.posts_delivered = 0
        self.foreign = 0
        self.errors = 0
        self.missed = 0  # races another host solved, none of whose posts came
        self.late = 0    # ... whose post came only after this host's race ended
        self.last_error: Optional[str] = None

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        """Open the socket and the wake pipe, publish the socket's address
        and start the thread."""
        family = socket.getaddrinfo(self.host, 0, type=socket.SOCK_DGRAM)[0][0]
        self._sock = socket.socket(family, socket.SOCK_DGRAM)
        self._sock.bind((self.host, 0))
        self._sock.setblocking(False)
        self._pipe = os.pipe()
        for fd in self._pipe:
            os.set_blocking(fd, False)
        self.address = self._sock.getsockname()[:2]
        self.store.set(f"addr/{self.rank}", f"{self.address[0]} {self.address[1]}")
        self._thread = threading.Thread(target=self._run, daemon=True, name="race-relay")
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stopping.set()
        self._wake.set()
        self.poke()
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(timeout=timeout)
        if self._sock is not None and not self.alive:
            self._sock.close()
            pipe, self._pipe = self._pipe, None
            for fd in pipe or ():
                os.close(fd)

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def health(self) -> dict:
        return {"alive": self.alive, "races": self.races, "posts_sent": self.posts_sent,
                "posts_delivered": self.posts_delivered, "foreign": self.foreign,
                "errors": self.errors, "missed": self.missed, "late": self.late,
                "last_error": self.last_error, "last": self.last}

    def poke(self) -> None:
        """Wake the thread from its wait on the socket (a post, a launch,
        the race's end or close, ``stop``)."""
        pipe = self._pipe
        if pipe is not None:
            try:
                os.write(pipe[1], b"!")
            except OSError:  # full (the thread has bytes to read) or closed
                pass

    # -- the loop thread's side -------------------------------------------
    def begin(self, race: int, card: bool = False) -> RaceLink:
        """Start serving race ``race``; ``card``: it runs on a card (the
        relay words are made now, so the library serves it from the
        start)."""
        link = RaceLink(self, race, card)
        if card:
            from ..ops.cuda_solver import race_relay_words

            self._host = race_relay_words()[1]
        self._link = link
        self._wake.set()
        return link

    def finish(self, link: RaceLink, solved_elsewhere: bool = False,
               timeout: float = RELAY_FINISH_S) -> None:
        """End ``link``'s race: the thread delivers nothing more for it.
        Waits (``timeout``) for the thread to leave it. ``solved_elsewhere``:
        another host's records of this race hold a solve, so that host
        posted it; if no post of it came here, it may still come for
        ``RELAY_LATE_S``, else the race is counted ``missed``."""
        link.close()
        if self._link is link:
            self._link = None
        left = not link.picked or not self.alive or link.quiet.wait(timeout)
        if not left:
            logger.warning("race relay: still in race %d after %.1f s", link.race, timeout)
        if solved_elsewhere and left and not link.heard and link.failed is None:
            self._await_late(link)
        self.last = link.summary()

    def _await_late(self, link: RaceLink) -> None:
        """Another host solved ``link``'s race and none of its posts came
        while the race ran here: read the socket for one for up to
        ``RELAY_LATE_S`` (the thread has left the race), else count the
        race missed."""
        deadline = time.monotonic() + RELAY_LATE_S
        while self._sock is not None and self._peers is not None:
            self._receive(link)
            if link.heard:
                self.late += 1
                return
            wait = deadline - time.monotonic()
            if wait <= 0:
                break
            select.select([self._sock], [], [], wait)
        self.missed += 1
        logger.warning("race relay: another host solved race %d, but none of its posts "
                       "reached this host (%d races missed so far): its shards ran "
                       "without the other hosts' stop", link.race, self.missed)

    # -- the outbox and inbox (CUDA) ---------------------------------------
    def words(self, link: RaceLink) -> tuple:
        """The relay words for ``link``'s launch (``cuda_solver.
        race_relay_words``): the outbox set idle, the inbox given
        ``link``'s relayed step if one came before the launch. Tells the
        thread that the race is launched. Returns their device address and
        host address."""
        from ..ops.cuda_solver import race_relay_words

        device, host = race_relay_words()
        ctypes.c_uint64.from_address(host).value = _OUTBOX_IDLE
        self._host = host
        if link.remote != RELAY_IDLE:
            self._write_inbox(host, link, link.remote)
        link._launched.value = 1
        self.poke()
        return device, host

    @staticmethod
    def _write_inbox(host: int, link: RaceLink, step: int) -> None:
        """``step`` into the inbox for ``link``'s race, unless it holds a
        lower one of that race."""
        word = ctypes.c_uint64.from_address(host + 8)
        held = word.value
        if (held & 0xFFFFFFFF) != link.tag or step < held >> 32:
            word.value = step << 32 | link.tag

    # -- the thread --------------------------------------------------------
    def _run(self) -> None:
        while not self._stopping.is_set():
            self._wake.wait(0.5)
            self._wake.clear()
            link = self._link
            if link is None or link.picked:
                continue
            link.picked = True
            link.picked_ns = time.monotonic_ns()
            try:
                self._serve(link)
            except Exception as e:  # noqa: BLE001 — reported, never a stop
                self.errors += 1
                self.last_error = f"race {link.race}: {type(e).__name__}: {e}"
                link.failed = self.last_error
                logger.exception("race relay: race %d runs on without the other "
                                 "hosts' posts", link.race)
            finally:
                link.left_ns = time.monotonic_ns()
                link.quiet.set()

    def _resolve(self) -> tuple:
        """The other hosts' relay addresses, once each has published it."""
        keys = [f"addr/{r}" for r in range(self.world) if r != self.rank]
        deadline = time.monotonic() + RELAY_RESOLVE_S
        while not self.store.check(keys):
            if self._stopping.is_set() or time.monotonic() > deadline:
                raise TimeoutError("the other hosts' relays have not published "
                                   "their addresses")
            self._stopping.wait(0.05)
        peers = []
        for key in keys:
            host, port = self.store.get(key).decode().split()
            peers.append((host, int(port)))
        self._peer_addrs = b"".join(_sockaddr(self._sock.family, h, p) for h, p in peers)
        return tuple(peers)

    def _serve(self, link: RaceLink) -> None:
        self.races += 1
        if self._peers is None:
            self._peers = self._resolve()
        early = self._early.pop(link.race, RELAY_IDLE)
        self._early = {r: s for r, s in self._early.items() if r > link.race}
        if early != RELAY_IDLE:
            self._take(link, early)
        sent = RELAY_IDLE
        while not (link.closed or self._stopping.is_set()):
            link.polls += 1
            if self._host is not None and (link.card or link._launched.value):
                sent, over = self._serve_card(link, sent)
                if over:
                    return
                continue
            done = link.ended()
            local = link.local  # read once: the race may lower it meanwhile
            if local < sent:
                seen_ns = time.monotonic_ns()
                data = f"{link.race}:{local}".encode()
                for peer in self._peers:
                    self._sock.sendto(data, peer)
                sent = local
                self._sent(link, sent, seen_ns, time.monotonic_ns())
            if done:
                return
            ready, _, _ = select.select([self._sock, self._pipe[0]], [], [],
                                        RELAY_ROUND_US / 1e6)
            if self._pipe[0] in ready:
                self._drain_pipe()
            if self._sock in ready:
                self._receive(link)

    def _drain_pipe(self) -> None:
        try:
            while os.read(self._pipe[0], 64):
                pass
        except BlockingIOError:
            pass

    def _sent(self, link: RaceLink, step: int, seen_ns: int, sent_ns: int) -> None:
        if link.sent_step is None:
            link.sent_step, link.sent_ns, link.posted_ns = step, seen_ns, sent_ns
        self.posts_sent += 1

    def _serve_card(self, link: RaceLink, sent: int) -> tuple:
        """One round of the library's service of ``link``'s race on a card
        (``cuda_solver.race_relay_serve``); returns the least step sent and
        whether this host's race has ended."""
        from ..ops.cuda_solver import race_relay_serve

        if self._c is None:
            self._c = (ctypes.c_uint(), (ctypes.c_ulonglong * 3)(),
                       ctypes.create_string_buffer(64), ctypes.c_int())
        c_sent, out, buf, length = self._c
        c_sent.value = sent
        rc = race_relay_serve(
            self._sock.fileno(), self._pipe[0], self._peer_addrs, len(self._peers),
            len(self._peer_addrs) // max(len(self._peers), 1), self._host, link.tag,
            link.race, ctypes.byref(c_sent), out, buf, ctypes.byref(length),
            ctypes.byref(link._closed), ctypes.byref(link._launched), link._c_ends,
            ctypes.byref(link._n_ends), RELAY_ROUND_US)
        if rc < 0:
            raise OSError(-rc, os.strerror(-rc))
        if rc == 1:
            self._sent(link, out[0], out[1], out[2])
        elif rc == 2:
            link.heard = True
            self._received(link, out[0], out[1], out[2])
        elif rc == 3:
            race, step = _parse(buf.raw[:length.value])
            if race > link.race:
                self._early[race] = min(self._early.get(race, RELAY_IDLE), step)
        elif rc == 4:
            self.foreign += 1
        return c_sent.value, rc == 5

    def _receive(self, link: RaceLink) -> None:
        """Every datagram waiting on the socket: this race's posts are
        delivered, a later race's kept, an earlier race's dropped."""
        while True:
            try:
                data, sender = self._sock.recvfrom(64)
            except BlockingIOError:
                return
            try:
                race, step = _parse(data)
            except ValueError:
                race = None
            if race is None or tuple(sender[:2]) not in self._peers:
                self.foreign += 1
                continue
            if race == link.race:
                link.heard = True
                self._take(link, step)
            elif race > link.race:
                self._early[race] = min(self._early.get(race, RELAY_IDLE), step)

    def _take(self, link: RaceLink, step: int) -> None:
        if step >= link.remote or link.closed:
            return
        received_ns = time.monotonic_ns()
        link.remote = min(link.remote, step)
        if self._host is not None:
            self._write_inbox(self._host, link, step)
        self._received(link, step, received_ns, time.monotonic_ns())

    def _received(self, link: RaceLink, step: int, received_ns: int,
                  written_ns: int) -> None:
        link.remote = min(link.remote, step)
        if link.received_step is None:
            link.received_step, link.received_ns = step, received_ns
            link.delivered_ns = written_ns
        self.posts_delivered += 1
