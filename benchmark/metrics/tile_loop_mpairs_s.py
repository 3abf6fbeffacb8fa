"""Million pairs a second of the tile loop alone: engine.dist_tiles drained
over the job's index as the job calls it (K3, key blocks, pulls), timed by
the benchmark on the host clock after the window."""

from benchmark.yardstick import readers


def read(run):
    return run.state["pairs"] / readers.tile_loop_s(run) / 1e6
