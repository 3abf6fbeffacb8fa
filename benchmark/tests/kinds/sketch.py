"""The `sketch` job kind in the benchmark's CPU tests: the sizes of its
sound runs and of its control, and the faults its judge has to notice."""

import miekki_tpu_torch.ops.sketch as sketch_ops

INF = (1 << 63) - 1

# configuration and workload keys of a sound CPU run
TINY = {"genome_bases": 3000, "s": 64, "genomes": 16, "genomes_per_job": 8}
# large enough for 32-bit codes to collide: the control's sizes
CONTROL = {"genome_bases": 20000, "s": 2048, "genomes": 24, "genomes_per_job": 8}


def _alter_sketch(orig):
    def fn(*a, **kw):
        keys = orig(*a, **kw).clone()
        keys[0, 0] -= 1  # one sketch value altered where it is made
        return keys
    return fn


def _half_sketch(orig):
    def fn(*a, **kw):
        keys = orig(*a, **kw).clone()
        keys[keys.shape[0] // 2:] = INF  # half of the batch left out
        return keys
    return fn


# (module, attribute, wrapper): the program broken where the judge must notice
FAULTS = [
    (sketch_ops, "sketch_chunked", _alter_sketch),
    (sketch_ops, "sketch_chunked", _half_sketch),
]
