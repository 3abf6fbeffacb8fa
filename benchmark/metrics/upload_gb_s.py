"""GB a second over the host-to-device link in the sketch jobs: the bytes
the program's `sketch.upload` span counts (each batch's genome bases,
written once into pinned staging and copied to the card without
blocking) over the device seconds of the window's `Memcpy HtoD`
operations in the trace.  The span itself holds only the copies'
enqueue, so its host seconds do not time the link."""

from benchmark.yardstick import readers, spans


def read(run):
    return spans.per(spans.count("sketch.upload", "bytes"), readers.host_to_device_s(run),
                     1e-9)
