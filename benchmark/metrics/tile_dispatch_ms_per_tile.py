"""Host milliseconds a tile of dist_tiles' dispatch in the count-matrix
jobs: the program's `dist.dispatch` span (the tile's kernel queued, its
pull started, the next missed key block loaded) over the window's tiles."""

from benchmark.yardstick import spans


def read(run):
    return spans.per(spans.seconds("dist.dispatch"), spans.tiles(run), 1e3)
