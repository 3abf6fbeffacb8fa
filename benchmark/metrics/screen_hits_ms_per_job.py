"""Host milliseconds a screen job spends from the hit bitmap to the TSV:
the program's `screen.pull` (the bitmap packed to bits and pulled),
`screen.hits` (each genome's distinct hits from it) and `screen.rows`
(the rows with their intervals and p-values, and the TSV text and write)
spans over the window's jobs."""

from benchmark.yardstick import spans


def read(run):
    return spans.per(spans.seconds("screen.pull", "screen.hits", "screen.rows"), len(run.walls),
                     1e3)
