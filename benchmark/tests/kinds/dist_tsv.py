"""The `dist_tsv` job kind in the benchmark's CPU tests: the sizes of its
sound runs and of its control, and the faults its judge has to notice."""

import numpy as np

import miekki_tpu_torch.engine as engine
import miekki_tpu_torch.oracle.compare as oracle_compare

# configuration and workload keys of a sound CPU run: 16 sketches in 2
# families over 2 x 2 blocks, and k = 9, small enough that the chance
# p-values of related pairs fall strictly between 0 and 1
TINY = {"s": 64, "genomes": 16, "tile": 8, "k": 9}
# wide enough for values cut to 32 bits to collide across unrelated pairs:
# the control's sizes
CONTROL = {"s": 2048, "genomes": 24, "tile": 8, "k": 9}


def _swap_columns(orig):
    def fn(self, *args):
        text, n = orig(self, *args)
        rows = [r.split("\t") for r in text.splitlines()]
        for r in rows:
            r[2], r[3] = r[3], r[2]  # shared and union trade places
        return "".join("\t".join(r) + "\n" for r in rows), n
    return fn


def _drop_row(orig):
    def fn(self, *args):
        text, n = orig(self, *args)
        return text.split("\n", 1)[1], n - 1  # the block's first row left out
    return fn


def _distance_f32(orig):
    def fn(j, k):
        return orig(j, k).astype(np.float32).astype(np.float64)
    return fn


# (module, attribute, wrapper): the program broken where the judge must notice
FAULTS = [
    (engine._BlockFormatter, "format", _swap_columns),
    (engine._BlockFormatter, "format", _drop_row),
    (oracle_compare, "mash_distance_vec", _distance_f32),
]
