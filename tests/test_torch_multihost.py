"""The port's multi-host serving loop, two ranks on a gloo group, on the CPU.

Two child processes (parallel/sim.py's environment: each sees a 2-shard
virtual CPU mesh, so the global mesh has 4 shards) join a gloo group over
127.0.0.1 and run ``FrontierServingLoop``: the leader's batch fan-out and
a race across both ranks answer exactly as the JAX package's
single-process 4-device mesh (JAX ``tests/test_multihost.py``'s sim
fan-out); and a follower SIGKILLed outside any collective degrades the
leader (its race falls back to the bucket path, its health reads dead)
within its stall limit instead of hanging it, its race's relay thread
(parallel/relay.py) alive meanwhile and ended after ``stop``. Every child has a
``subprocess`` timeout and every collective the loop's timeout.
"""

import json
import os
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest

from sudoku_solver_distributed_tpu.engine import SolverEngine as JaxEngine
from sudoku_solver_distributed_tpu.models import generate_batch
from sudoku_solver_distributed_tpu.ops import SPEC_9
from sudoku_solver_distributed_tpu.parallel import frontier as JF
from sudoku_solver_distributed_tpu.parallel.mesh import default_mesh as jax_default_mesh
from sudoku_solver_distributed_tpu_torch.parallel import sim

README = [[0, 0, 0, 1, 0, 0, 0, 0, 0], [0, 0, 0, 3, 2, 0, 0, 0, 0],
          [0, 0, 0, 0, 0, 9, 0, 0, 0], [0, 0, 0, 0, 0, 0, 0, 7, 0],
          [0, 0, 0, 0, 0, 0, 0, 0, 0], [0, 0, 0, 9, 0, 0, 0, 0, 0],
          [0, 0, 0, 0, 0, 0, 9, 0, 0], [0, 0, 0, 0, 0, 0, 0, 0, 3],
          [0, 0, 0, 0, 0, 0, 0, 0, 0]]
CHILD_TIMEOUT_S = 90

# one rank of the fan-out: a mesh engine over this rank's 2 shards whose
# ladder rounds to the global 4, the loop armed on both ranks; the leader
# solves a batch through the fan-out and races the README across both ranks
_RANK = r"""
import json, sys
from datetime import timedelta
import numpy as np
import torch.distributed as dist

rank, port, boards_json = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank, timeout=timedelta(seconds=30))
from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
from sudoku_solver_distributed_tpu_torch.parallel import FrontierServingLoop, default_mesh

mesh = default_mesh()
assert mesh.size == 2 and mesh.virtual
eng = SolverEngine(device="cpu", mesh=mesh, buckets=(4, 8), coalesce=False,
                   bucket_multiple=4)
loop = FrontierServingLoop(mesh, eng.spec, states_per_device=8,
                           max_depth=eng.max_depth, locked=eng.locked_candidates,
                           waves=eng.waves, naked_pairs=eng.naked_pairs,
                           collective_timeout_s=30)
loop.enable_batch_fanout(eng)
loop.start(warm_race=False)
if rank == 0:
    loop.warm_batch_fanout(eng.buckets[0], eng.max_iters)
    eng.mesh_runner = loop.solve_padded
    boards = np.asarray(json.loads(boards_json), np.int32)
    sols, mask, info = eng.solve_batch_np(boards)
    race_sol, race_info = loop.solve(np.asarray(json.loads(sys.argv[4]), np.int32))
    h = loop.health()
    out = {"sols": sols.tolist(), "mask": mask.tolist(), "info": info,
           "race": [race_sol, race_info], "alive": h["alive"],
           "batches": h["batches"], "runner": eng.mesh_runner_dispatches,
           "continuous": eng.continuous_active, "buckets": list(eng.buckets)}
    loop.stop()
    print(json.dumps(out), flush=True)
else:
    loop.join(timeout=80)
    print(json.dumps({"follower": "stopped", "batches": loop.health()["batches"]}),
          flush=True)
dist.destroy_process_group()
"""

# the leader of the killed-follower case: warm race with the follower alive,
# then the parent SIGKILLs the follower while the loop idles in broadcast
_LEADER_KILLED = r"""
import json, os, sys, time
from datetime import timedelta
import torch.distributed as dist

port, flag, killed_flag, board_json = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=0, timeout=timedelta(seconds=20))
from sudoku_solver_distributed_tpu_torch.engine import SolverEngine
from sudoku_solver_distributed_tpu_torch.models import oracle_is_valid_solution
from sudoku_solver_distributed_tpu_torch.parallel import FrontierServingLoop, default_mesh

loop = FrontierServingLoop(default_mesh(), states_per_device=4, max_restarts=1,
                           stall_after_s=3.0, collective_stall_after_s=5.0,
                           collective_timeout_s=10)
loop.start()  # warm race: the follower is alive here
assert loop.relay.alive and loop.health()["relay"]["races"] == 1, loop.health()
open(flag, "w").close()
deadline = time.monotonic() + 30
while not os.path.exists(killed_flag):
    assert time.monotonic() < deadline, "the parent never confirmed the kill"
    time.sleep(0.05)
time.sleep(0.5)  # the death lands while this loop idles in broadcast
eng = SolverEngine(device="cpu", buckets=(1,), frontier_route="always", coalesce=False)
eng.frontier_runner = lambda a: loop.solve(a, timeout=8.0)
eng.frontier_loop = loop
t0 = time.monotonic()
solution, info = eng.solve_one(json.loads(board_json))
elapsed = time.monotonic() - t0
assert solution is not None and oracle_is_valid_solution(solution), "no answer"
assert not info.get("frontier"), "must have fallen back to the bucket path"
assert eng.frontier_fallbacks == 1, eng.frontier_fallbacks
deadline = time.monotonic() + 3.0 + 1.0  # the stall limit, and a tick
while loop.health()["alive"] and time.monotonic() < deadline:
    time.sleep(0.05)
h = loop.health()
assert h["alive"] is False, h
assert eng.health()["frontier_loop_alive"] is False
loop.stop()
print(json.dumps({"elapsed_s": elapsed, "health": h,
                  "relay_alive_after_stop": loop.relay.alive}), flush=True)
os._exit(0)  # the group cannot shut down cleanly with a killed peer
"""

_FOLLOWER_WAIT = r"""
import sys
from datetime import timedelta
import torch.distributed as dist

dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{sys.argv[1]}",
                        world_size=2, rank=1, timeout=timedelta(seconds=20))
from sudoku_solver_distributed_tpu_torch.parallel import FrontierServingLoop, default_mesh

loop = FrontierServingLoop(default_mesh(), states_per_device=4, max_restarts=1,
                           stall_after_s=3.0, collective_stall_after_s=5.0,
                           collective_timeout_s=10)
loop.start()
loop.join(timeout=60)  # the parent SIGKILLs this process meanwhile
"""


def _free_tcp_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(code: str, *args) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-c", code, *[str(a) for a in args]],
        env=sim.virtual_mesh_env(2, device="cpu"), cwd=sim.REPO_ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def _last_json(out: str) -> dict:
    lines = [ln for ln in out.strip().splitlines() if ln.startswith("{")]
    assert lines, out[-3000:]
    return json.loads(lines[-1])


def _reap(*procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def test_sim_harness_env_and_run_json():
    env = sim.virtual_mesh_env(3, device="cpu", base={"PYTHONPATH": "x"})
    assert env["SUDOKU_VIRTUAL_MESH"] == "3@cpu"
    assert env["PYTHONPATH"].split(os.pathsep) == [sim.REPO_ROOT, "x"]
    out = sim.run_json(
        "import json; from sudoku_solver_distributed_tpu_torch.parallel import "
        "default_mesh; m = default_mesh(); print(json.dumps([m.size, str(m.primary)]))",
        3, timeout=CHILD_TIMEOUT_S,
    )
    assert out == [3, "cpu"]
    with pytest.raises(AssertionError, match="failed"):
        sim.run_py("raise SystemExit(3)", 1, timeout=CHILD_TIMEOUT_S)


def test_two_ranks_fan_out_and_race_as_the_jax_four_device_mesh():
    boards = generate_batch(6, 55, seed=43)
    port = _free_tcp_port()
    ranks = [_spawn(_RANK, r, port, json.dumps(boards.tolist()), json.dumps(README))
             for r in (0, 1)]
    try:
        outs = [p.communicate(timeout=CHILD_TIMEOUT_S)[0] for p in ranks]
    finally:
        _reap(*ranks)
    assert [p.returncode for p in ranks] == [0, 0], outs[0][-3000:] + outs[1][-3000:]
    lead, follow = (_last_json(o) for o in outs)
    assert follow["follower"] == "stopped"
    # the JAX references: one device for the batch (6 boards in an 8-wide
    # bucket: three sweeps a step, as every mesh shard runs), the
    # single-process 4-device mesh for the race
    jeng = JaxEngine(buckets=(4, 8), coalesce=False)
    try:
        jsols, jmask, jinfo = jeng.solve_batch_np(boards)
        jsol, jrinfo = JF.frontier_solve(
            np.asarray(README), jax_default_mesh(jax.devices()[:4]), SPEC_9,
            states_per_device=8, max_depth=jeng.max_depth,
            locked=jeng.locked_candidates, waves=jeng.waves,
            naked_pairs=jeng.naked_pairs,
        )
    finally:
        jeng.close()
    assert lead["sols"] == jsols.tolist() and lead["mask"] == jmask.tolist()
    assert lead["info"] == jinfo
    assert lead["race"] == [jsol, jrinfo]
    assert lead["alive"] is True and lead["buckets"] == [4, 8]
    assert lead["batches"] == follow["batches"] == 2  # the warm-up and the batch
    assert lead["runner"] == 1 and lead["continuous"] is False


def test_follower_death_outside_a_collective_degrades_the_leader(tmp_path):
    port = _free_tcp_port()
    flag, killed = tmp_path / "warm.flag", tmp_path / "killed.flag"
    leader = _spawn(_LEADER_KILLED, port, flag, killed, json.dumps(README))
    follower = _spawn(_FOLLOWER_WAIT, port)
    try:
        deadline = time.monotonic() + CHILD_TIMEOUT_S
        while not flag.exists() and time.monotonic() < deadline:
            if leader.poll() is not None:
                raise AssertionError(f"leader died early:\n{leader.communicate()[0][-3000:]}")
            time.sleep(0.05)
        assert flag.exists(), "the warm race never completed"
        follower.kill()  # a host-local death, outside any collective
        follower.wait()
        killed.touch()
        out, _ = leader.communicate(timeout=CHILD_TIMEOUT_S)
    finally:
        _reap(leader, follower)
    assert leader.returncode == 0, out[-3000:]
    res = _last_json(out)
    assert res["health"]["alive"] is False
    assert res["elapsed_s"] < 10.0  # the solve's 8 s bound, never a hang
    # the race's relay thread lived through the death and ended with the loop
    assert res["relay_alive_after_stop"] is False
