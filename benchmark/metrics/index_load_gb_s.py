"""GB a second of the dist jobs' index loads: the file bytes that the
program's `index.load` span counts over its host seconds (the npz read and
inflated into the hi and lo planes)."""

from benchmark.yardstick import spans


def read(run):
    return spans.per(spans.count("index.load", "bytes"), spans.seconds("index.load"), 1e-9)
