"""GB a second of the dist jobs' TSV writes: the characters that the
program's `dist.write` spans count (one a formatted block, all ASCII, so
bytes) over their host seconds."""

from benchmark.yardstick import spans


def read(run):
    return spans.per(spans.count("dist.write", "bytes"), spans.seconds("dist.write"), 1e-9)
