"""Host milliseconds of the sketch jobs' batching per Gbase sketched: the
program's `sketch.bucket` (chunk rows and shape groups) and `sketch.pack`
(each batch's INVALID-padded stack) spans over the window's Gbase."""

from benchmark.yardstick import spans


def read(run):
    return spans.per(spans.seconds("sketch.bucket", "sketch.pack"), spans.gbase(run), 1e3)
