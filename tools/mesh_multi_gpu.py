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
  (c) the race across the cards (K4's shard form on each card, the run
      records copied to card 0, the fold kernel there) against the plain
      race on chip_smoke.py's phase 11 sets, each timed by CUDA events
      beside the one-card race of the same padded states, with each card's
      steps past t*;
  (n) one process a card on an NCCL group (``FrontierServingLoop``): a
      coalesced batch fanned out across the cards, with one card's grids
      and the plain version's counters, and the README board raced across
      them, equal to the plain race over as many shards.

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

    out = {"mismatches": 0, "sets": {}}
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

        def race():
            mesh.streams[0].wait_stream(torch.cuda.current_stream())
            return F.race_on_mesh(states, mesh, spec, spec.max_depth, max_iters, **sweeps)

        krow, kfold, kmeta = race()
        torch.cuda.synchronize()
        bad, _ = chip_smoke._race_diffs((krow, kfold), (prow, pfold))
        out["mismatches"] += bad
        steps = kmeta[:, 1].cpu().numpy()
        solved = kmeta[:, 0].cpu().numpy() == 1
        t_star = int(steps[solved].min()) if solved.any() else int(steps.max())
        per = M // mesh.size
        past = [max(0, int(steps[i * per:(i + 1) * per].max()) - t_star)
                for i in range(mesh.size)]
        mesh_ms = float(np.median(chip_smoke._event_ms(race, 5)))
        one_ms = float(np.median(chip_smoke._event_ms(
            lambda: cs.dfs_race(flat, spec, spec.max_depth, max_iters, **sweeps), 5)))
        out["sets"][name] = {"states": M, "t_star": t_star, "mismatches": bad,
                             "steps_past_t_star_by_card": past,
                             "k4_and_fold_ms": mesh_ms, "one_card_ms": one_ms}
        log(f"(c) {name}: {M} states over {mesh.size} cards: {bad} mismatches; "
            f"{mesh_ms:.4f} ms vs one card {one_ms:.4f} ms (CUDA events, median of 5); "
            f"steps past t* by card {past}")
    check(out["mismatches"] == 0, f"(c): {out['mismatches']} mismatches")
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
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
