"""Host milliseconds a tile of the key blocks' loads in the count-matrix
jobs: the program's `dist.block_load` span (a block sliced from device
planes into a lane-padded copy, or staged from host planes and uploaded)
over the window's tiles."""

from benchmark.yardstick import spans


def read(run):
    return spans.per(spans.seconds("dist.block_load"), spans.tiles(run), 1e3)
