"""Host milliseconds a screen job spends on the flat DB: the program's
`screen.flatten` span (the index's table to the card, one stable sort,
its values and genome ids pulled) over the window's jobs."""

from benchmark.yardstick import spans


def read(run):
    return spans.per(spans.seconds("screen.flatten"), len(run.walls), 1e3)
