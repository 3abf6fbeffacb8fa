"""Host milliseconds of the screen jobs' hashing and joining a batch: the
program's `screen.join` span (K1 over the packed batch, its sort and the
sorted join against the flat DB, the KMV update with -p), opened once a
batch, over its calls."""

from benchmark.yardstick import spans


def read(run):
    return spans.per(spans.seconds("screen.join"), spans.count("screen.join", "calls"), 1e3)
