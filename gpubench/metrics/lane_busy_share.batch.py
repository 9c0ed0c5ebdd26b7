"""The share of K1's lockstep lane-steps that did work in the window, in %:
1 - idle_lane_steps / lane_steps, the window's growth of the engine's cost
plane (obs/cost.py), which a mesh call fills with each shard's lockstep
counts. On one card the engine counts no idle lane-steps (each board its
own warp), so there is nothing to read there."""


def read(run):
    lane = run.cost_after["lane_steps"] - run.cost_before["lane_steps"]
    idle = run.cost_after["idle_lane_steps"] - run.cost_before["idle_lane_steps"]
    if lane <= 0 or idle <= 0:
        return None
    return 100.0 * (lane - idle) / lane
