"""Host milliseconds a tile that the count-matrix jobs wait for a tile's
counts to reach the host: the program's `dist.pull_wait` span over the
window's tiles."""

from benchmark.yardstick import spans


def read(run):
    return spans.per(spans.seconds("dist.pull_wait"), spans.tiles(run), 1e3)
