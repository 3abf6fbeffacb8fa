"""Gbase a second of the FASTA parse inside the sketch jobs: the window's
Gbase over the program's `sketch.parse` span (the reader and packing map
over the files, 8 threads, timed on the job's thread)."""

from benchmark.yardstick import spans


def read(run):
    return spans.per(spans.gbase(run), spans.seconds("sketch.parse"))
