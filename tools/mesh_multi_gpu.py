"""Drive the mesh plane over every card of one host: a mesh of real GPUs,
NCCL across them.

    python3 tools/mesh_multi_gpu.py            # needs two or more CUDA cards
    python3 tools/mesh_multi_gpu.py --cpu-ranks 4   # the ranks' part on gloo, CPU

With the cards (chip_smoke.py's phase 13 runs the same checks on a virtual
mesh of one card):

  (a) ``SolverEngine(mesh=default_mesh())`` over every card against the
      one-card engine: the 4096 hard boards in one bucket call each, every
      row equal (grid, status, guesses, validations), one K1 launch a card,
      ``engine.mesh`` showing a shard a card;
  (c) the race across the cards (K4's shard form on each card, from one
      library call) against the plain race on chip_smoke.py's phase 11
      sets, each timed by CUDA events beside the one-card race of the same
      padded states; first the peer-access matrix of the cards and the
      stop's layout chosen from it: ``"peer"`` (a stop word on each card,
      posted to over NVLink, a launch a card, the last block across every
      card folding) where every two cards reach each other, else
      ``"host"`` (slots in mapped host memory, the records copied to card 0
      and folded there by the fold kernel). After one untimed race a set,
      each card's steps past t* in the 5 timed races and in three races
      with the kernel's clock (by card, after its first block's start: the
      spread of its blocks' starts, their µs a step, when a block of it
      solved at t* and at what rate, when its first block stopped on the
      posted step, when its last search ended; ``clocked_race``) are
      printed, and the card that solved at t* is held to chip_smoke.py's
      bound: at most 2, or one more than the most the one-card race's
      blocks run past t* in its 5 timed races. The other cards are not:
      each card's launch starts a few µs after the one before, and a card
      launched before the solving card runs that many steps further
      before the post reaches it (phase 13(c) measures this with the
      ``"peer"`` layout forced on one card, under one timer);
  (n) one process a card on an NCCL group (``FrontierServingLoop``): a
      coalesced batch fanned out across the cards, with one card's grids
      and the plain version's counters, and the README board raced across
      them, equal to the plain race over as many shards.

  (r) with four cards or more, two processes of half the cards each (a
      shard a card, the peer layout inside a process) on an NCCL group:
      ``chip_smoke.py``'s phase 13(d) relay sets through the serving loop,
      the race's relay across hosts carrying each process's solves to the
      other (``chip_smoke._mesh_relay``): every answer the plain race's,
      no state halted before t*, each rank's steps past t* and the
      relay's latency printed.

``--cpu-ranks N`` runs (n) alone with N CPU processes on a gloo group, a
shard each: the rehearsal of the multi-process path without cards.

Prints a line per check, the cards' names and power limits, and last one
JSON object. Exits non-zero without a result when it finds fewer than two
CUDA cards (and no ``--cpu-ranks``).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one rank of (n): its own card (or the CPU), a one-shard mesh, the ladder
# rounded to the global shard count; rank 0 fans a batch out and races the
# README across every rank. argv: rank, world, port, backend, device,
# boards, README
_RANK = r"""
import json, sys, time
from datetime import timedelta
import numpy as np
import torch
import torch.distributed as dist

rank, world, port, backend, device = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                      sys.argv[4], sys.argv[5])
if device == "cuda":
    torch.cuda.set_device(rank)
    device = f"cuda:{rank}"
dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                        world_size=world, rank=rank, timeout=timedelta(seconds=120))
from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
from sudoku_solver_distributed_tpu_torch.parallel import FrontierServingLoop, Mesh

mesh = Mesh([device])
eng = SolverEngine(device=device, buckets=(4, 8), coalesce=False, bucket_multiple=world)
loop = FrontierServingLoop(mesh, eng.spec, states_per_device=8, max_depth=eng.max_depth,
                           locked=eng.locked_candidates, waves=eng.waves,
                           naked_pairs=eng.naked_pairs, collective_timeout_s=120)
loop.enable_batch_fanout(eng)
loop.start(warm_race=False)
if rank == 0:
    loop.warm_batch_fanout(eng.buckets[0], eng.max_iters)
    eng.mesh_runner = loop.solve_padded
    boards = np.asarray(json.loads(sys.argv[6]), np.int32)
    t0 = time.perf_counter()
    sols, mask, info = eng.solve_batch_np(boards)
    t1 = time.perf_counter()
    race = loop.solve(np.asarray(json.loads(sys.argv[7]), np.int32))
    t2 = time.perf_counter()
    out = {"sols": sols.tolist(), "info": info, "race": race, "backend": loop.backend,
           "collective_device": str(loop._collective_device),
           "batch_ms": (t1 - t0) * 1e3, "race_ms": (t2 - t1) * 1e3}
    loop.stop()
    print(json.dumps(out), flush=True)
else:
    loop.join(timeout=300)
    print(json.dumps({"follower": rank}), flush=True)
dist.destroy_process_group()
"""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ranks(world: int, backend: str, device: str, boards, readme) -> dict:
    """(n): ``world`` processes on one group, rank r on card r (or the
    CPU); returns rank 0's JSON line."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("SUDOKU_VIRTUAL_MESH", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(world), str(port), backend, device,
         json.dumps(boards.tolist()), json.dumps(readme)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    ) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        check(p.returncode == 0, f"a rank failed:\n{o[-3000:]}")
    return json.loads([ln for ln in outs[0].splitlines() if ln.startswith("{")][-1])


def multi_rank(world: int, backend: str, device: str, cs) -> dict:
    """(n) against its plain references: the batch's grids and counters
    (a one-device CPU engine) and the README race over ``world`` shards
    (the plain race on a CPU virtual mesh)."""
    import numpy as np
    from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
    from sudoku_solver_distributed_tpu_torch.models import generate_batch
    from sudoku_solver_distributed_tpu_torch.parallel import frontier as F
    from sudoku_solver_distributed_tpu_torch.parallel.mesh import virtual_mesh

    import chip_smoke

    boards = generate_batch(6, 55, seed=43)
    ref = SolverEngine(device="cpu", buckets=(4, 8), coalesce=False)
    try:
        want_sols, _, want_info = ref.solve_batch_np(boards)
        want_race = F.frontier_solve(
            np.asarray(chip_smoke.README_PUZZLE), virtual_mesh("cpu", world), ref.spec,
            states_per_device=8, max_depth=ref.max_depth, locked=ref.locked_candidates,
            waves=ref.waves, naked_pairs=ref.naked_pairs)
    finally:
        ref.close()
    t0 = time.perf_counter()
    lead = ranks(world, backend, device, boards, chip_smoke.README_PUZZLE)
    wall = time.perf_counter() - t0
    check(lead["sols"] == want_sols.tolist() and lead["info"] == want_info,
          f"(n): the fan-out's answers {lead['info']} differ from {want_info}")
    check(lead["race"] == list(want_race),
          f"(n): the race {lead['race'][1]} differs from the plain {want_race[1]}")
    out = {k: lead[k] for k in ("info", "backend", "collective_device", "batch_ms",
                                "race_ms")}
    out.update(race_info=lead["race"][1], ranks=world, wall_s=wall)
    log(f"(n) {backend} x{world} on {device}: fan-out of 6 boards {lead['batch_ms']:.1f} ms, "
        f"the README race {lead['race_ms']:.1f} ms (host clock, rank 0); counters "
        f"{lead['info']}, race {lead['race'][1]}: equal to the plain versions")
    return out


def engine_on_cards(cs, mesh) -> dict:
    """(a) over the cards' mesh."""
    import numpy as np
    from sudoku_solver_distributed_tpu_torch.engine import SolverEngine

    import chip_smoke

    boards = chip_smoke.load_corpus("corpus_9x9_hard_4096.npz")
    em = SolverEngine(mesh=mesh, buckets=(1, 8, 64, 512, 4096), coalesce=False)
    es = SolverEngine(buckets=(1, 8, 64, 512, 4096), coalesce=False)
    try:
        em.warmup()
        es.warmup()
        C = em.spec.cells
        n0 = cs.dfs_solver.launches
        t0 = time.perf_counter()
        rm = em._solve_padded(boards)
        mesh_s = time.perf_counter() - t0
        k1 = cs.dfs_solver.launches - n0
        t0 = time.perf_counter()
        rs = es._solve_padded(boards)
        one_s = time.perf_counter() - t0
        bad = int((rm[:, :C + 4] != rs[:, :C + 4]).any(axis=1).sum())
        check(bad == 0, f"(a): {bad} rows differ from one card's")
        check(k1 == mesh.size, f"(a): {k1} K1 launches for {mesh.size} cards")
        mi = em.mesh_info()
        check(mi["last_split"] == {"devices": mesh.size,
                                   "rows_per_device": 4096 // mesh.size}, f"(a): {mi}")
    finally:
        em.close()
        es.close()
    out = {"cards": mesh.size, "k1_launches": k1, "mesh_call_ms": mesh_s * 1e3,
           "one_card_call_ms": one_s * 1e3, "device_kinds": mi["device_kinds"]}
    log(f"(a): 4096 hard boards over {mesh.size} cards equal one card's rows; "
        f"{k1} K1 launches; {out['mesh_call_ms']:.3f} vs {out['one_card_call_ms']:.3f} ms "
        "(host clock, one call each)")
    return out


def race_on_cards(cs, mesh) -> dict:
    """(c) over the cards' mesh, on phase 11's sets whose states divide it."""
    import numpy as np
    import torch
    from sudoku_solver_distributed_tpu_torch.ops.config import serving_config
    from sudoku_solver_distributed_tpu_torch.ops.spec import spec_for_size
    from sudoku_solver_distributed_tpu_torch.parallel import frontier as F

    import chip_smoke

    n = mesh.size
    peers = [[i != j and torch.cuda.can_device_access_peer(i, j) for j in range(n)]
             for i in range(n)]
    slots = F.mesh_race_slots(mesh)
    layout = slots.layout
    log(f"(c): peer access by card pair {peers}; the race's stop: {layout!r}")
    out = {"mismatches": 0, "peer_access": peers, "layout": layout, "sets": {}}
    over = []
    for name, board, spec, states, max_iters, _ in chip_smoke.frontier_race_sets(
            F, spec_for_size, chip_smoke.SYMMETRY_SEED):
        M, C = len(states), spec.cells
        if M % mesh.size:
            continue
        cfg = serving_config(spec.size) if spec.size != 4 else dict(
            locked_candidates=True, waves=1, naked_pairs=True)
        sweeps = chip_smoke.sweeps_of(cfg)
        flat = torch.as_tensor(states.reshape(M, C), device="cuda:0").contiguous()
        prow, pfold, _ = cs._dfs_race_plain(flat, spec, spec.max_depth, max_iters, **sweeps)

        metas = []

        def race():
            mesh.streams[0].wait_stream(torch.cuda.current_stream())
            row, fold, meta = F.race_on_mesh(states, mesh, spec, spec.max_depth, max_iters,
                                              **sweeps)
            metas.append(meta)
            return row, fold, meta

        # the first race of a set (untimed) warms every card
        krow, kfold, kmeta = race()
        torch.cuda.synchronize()
        bad, _ = chip_smoke._race_diffs((krow, kfold), (prow, pfold))
        out["mismatches"] += bad
        steps = kmeta[:, 1].cpu().numpy()
        solved = kmeta[:, 0].cpu().numpy() == 1
        t_star = int(steps[solved].min()) if solved.any() else int(steps.max())
        per = M // mesh.size

        def past_of(meta):
            steps = meta[:, 1].cpu().numpy()
            return [max(0, int(steps[i * per:(i + 1) * per].max()) - t_star)
                    for i in range(mesh.size)]

        def solvers_of(meta):
            # the cards holding a block that solved at t*: their blocks
            # started with it and read its post on their own card
            rec = meta.cpu().numpy()
            won = (rec[:, 0] == 1) & (rec[:, 1] == t_star)
            return [i for i in range(mesh.size) if won[i * per:(i + 1) * per].any()]

        first_past = past_of(kmeta)
        mesh_ms = float(np.median(chip_smoke._event_ms(race, 5)))
        timed_past = [past_of(m) for m in metas[1:]]
        solvers = [solvers_of(m) for m in metas[1:]]
        k4_metas = []
        one_ms = float(np.median(chip_smoke._event_ms(lambda: k4_metas.append(
            cs.dfs_race(flat, spec, spec.max_depth, max_iters, **sweeps)[2]), 5)))
        k4_past = max(int(m[:, 1].max()) - t_star for m in k4_metas)
        clocked = [clocked_race(cs, mesh, slots, states, spec, max_iters, t_star, sweeps)
                   for _ in range(3)]
        for c in clocked:
            if "meta" in c:
                meta = c.pop("meta")
                c["past"] = past_of(meta)
                timed_past.append(c["past"])
                solvers.append(solvers_of(meta))
        bound = max(chip_smoke.MESH_MAX_STEPS_PAST_T_STAR, k4_past + 1)
        worst = max((p[i] for p, w in zip(timed_past, solvers) for i in w), default=0)
        if worst > bound:
            over.append((name, worst, bound))
        out["sets"][name] = {"states": M, "t_star": t_star, "mismatches": bad,
                             "steps_past_t_star_first_race": first_past,
                             "steps_past_t_star_warm": timed_past,
                             "solving_cards": solvers,
                             "one_card_steps_past_t_star": k4_past, "bound": bound,
                             "clock": clocked, "race_ms": mesh_ms, "one_card_ms": one_ms}
        log(f"(c) {name}: {M} states over {mesh.size} cards ({layout} stop): {bad} "
            f"mismatches; the race {mesh_ms:.4f} ms vs one card {one_ms:.4f} ms (CUDA "
            f"events, median of 5); t* {t_star}; steps past t* by card: first race "
            f"{first_past}, warm {timed_past} (the solving cards {solvers} held to "
            f"{bound}; one card's blocks {k4_past}); the clocked race, by card (µs "
            f"after its first block's start) {clocked}")
    check(out["mismatches"] == 0, f"(c): {out['mismatches']} mismatches")
    # held to the bound in main, after (n) has run
    out["over_bound"] = over
    return out


def clocked_race(cs, mesh, slots, states, spec, max_iters: int, t_star: int,
                 sweeps: dict) -> dict:
    """One race across the cards through ``dfs_race_shards`` with the
    kernel's clock, under the ``"device"`` and ``"peer"`` layouts (its
    last block folds; under ``"host"`` the clock is not read). Each card
    reads its own globaltimer, and the cards' timers disagree by
    milliseconds, so every reading is taken on its card after its first
    block's start. By card, in µs: ``spread`` from its first block's start
    to its last's; ``step`` the median µs a step of its blocks (their
    search time over their steps); ``solve`` when a block of it ended its
    search solved at t*, with that block's µs a step (``solve_step``);
    ``first_stop`` when its first block stopped RUNNING on the posted
    step; ``last`` when its last search ended. On the card that solved,
    ``first_stop`` against ``solve`` is how soon its own blocks read the
    post; a card that stopped many steps past t* while the solving card's
    own blocks did not started early or read the post late. The race's
    records come back as ``meta``."""
    import numpy as np
    import torch

    if slots.layout == "host":
        return {"layout": "host", "read": False}
    M, C = len(states), spec.cells
    n = mesh.size
    per = M // n
    flat = torch.as_tensor(np.ascontiguousarray(states.reshape(M, C)))
    parts = [flat[i * per:(i + 1) * per].to(d).contiguous()
             for i, d in enumerate(mesh.devices)]
    clock = torch.zeros((M, 3), dtype=torch.int64, device=mesh.devices[0])
    for d in mesh.distinct_devices:
        torch.cuda.synchronize(d)
    with slots.lock:
        _, _, meta = cs.dfs_race_shards(parts, spec, spec.max_depth, max_iters,
                                        streams=list(mesh.streams), slots=slots, fold=True,
                                        clock=clock, **sweeps)
    for d in mesh.distinct_devices:
        torch.cuda.synchronize(d)
    ns = clock.cpu().numpy().reshape(n, per, 3).astype(np.float64)
    rec = meta.cpu().numpy().reshape(n, per, 4)
    out = {k: [] for k in ("spread", "step", "solve", "solve_step", "first_stop", "last")}
    for c in range(n):
        start, searched = ns[c, :, 0], ns[c, :, 1]
        status, steps = rec[c, :, 0], rec[c, :, 1]
        t0 = start.min()
        us = lambda x: round(float(x - t0) / 1e3, 3)  # noqa: E731
        rate = (searched - start) / np.maximum(steps, 1) / 1e3
        won = (status == 1) & (steps == t_star)
        stopped = status == 0
        out["spread"].append(us(start.max()))
        out["step"].append(round(float(np.median(rate)), 3))
        out["solve"].append(us(searched[won].min()) if won.any() else None)
        out["solve_step"].append(round(float(rate[won].min()), 3) if won.any() else None)
        out["first_stop"].append(us(searched[stopped].min()) if stopped.any() else None)
        out["last"].append(us(searched.max()))
    out["meta"] = meta
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu-ranks", type=int, default=0,
                        help="run the ranks' part alone on N CPU processes (gloo)")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from sudoku_solver_distributed_tpu_torch.ops import cuda_solver as cs

    if args.cpu_ranks:
        out = {"ranks": multi_rank(args.cpu_ranks, "gloo", "cpu", cs)}
        print(json.dumps(dict(out, platform="cpu")), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("mesh_multi_gpu: no CUDA device is available", file=sys.stderr)
        return 2
    n = torch.cuda.device_count()
    if n < 2:
        print(f"mesh_multi_gpu: {n} CUDA card; the mesh of real cards needs two or more",
              file=sys.stderr)
        return 2
    from sudoku_solver_distributed_tpu_torch.parallel import default_mesh

    import chip_smoke

    cards = chip_smoke.card_name_and_power_limit_all()
    log(f"cards: {cards}")
    mesh = default_mesh()
    check(mesh.size == n and not mesh.virtual, f"default_mesh() is {mesh}")
    out = {"cards": cards, "engine": engine_on_cards(cs, mesh),
           "race": race_on_cards(cs, mesh), "ranks": multi_rank(n, "nccl", "cuda", cs)}
    if n >= 4:
        from sudoku_solver_distributed_tpu_torch.models import oracle_is_valid_solution

        half = n // 2
        visible = [",".join(map(str, range(half))), ",".join(map(str, range(half, n)))]
        log(f"(r): two ranks over NCCL, cards {visible[0]} and {visible[1]}")
        out["relay"] = chip_smoke._mesh_relay(oracle_is_valid_solution, visible=visible,
                                              backend="nccl")
    print(json.dumps(out), flush=True)
    over = out["race"]["over_bound"]
    check(not over, f"(c): the solving card's steps past t* over the bound after a warm "
                    f"race (set, most, bound): {over}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
