"""Host milliseconds a tile of the count-matrix assembly: the program's
`dist.assemble` (each tile's rectangles slice-assigned into the matrices)
and `dist.fill` (deferred union, ambiguous pairs, diagonal) spans over
the window's tiles."""

from benchmark.yardstick import spans


def read(run):
    return spans.per(spans.seconds("dist.assemble", "dist.fill"), spans.tiles(run), 1e3)
