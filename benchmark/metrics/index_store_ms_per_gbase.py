"""Host milliseconds of the sketch jobs' index store per Gbase sketched:
the program's `index.assemble` (SketchIndex.from_sketches) and
`index.save` (the compressed npz) spans over the window's Gbase."""

from benchmark.yardstick import spans


def read(run):
    return spans.per(spans.seconds("index.assemble", "index.save"), spans.gbase(run), 1e3)
