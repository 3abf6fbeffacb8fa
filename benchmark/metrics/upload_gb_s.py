"""GB a second of the sketch jobs' code uploads: the bytes the program's
`sketch.upload` span counts (each batch's uint8 stack, from pageable
memory) over its host seconds."""

from benchmark.yardstick import spans


def read(run):
    return spans.per(spans.count("sketch.upload", "bytes"), spans.seconds("sketch.upload"),
                     1e-9)
