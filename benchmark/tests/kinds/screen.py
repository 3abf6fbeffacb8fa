"""The `screen` job kind in the benchmark's CPU tests: the sizes of its
sound runs and of its control, and the faults its judge has to notice."""

import miekki_tpu_torch.engine as engine
import miekki_tpu_torch.oracle.compare as oracle_compare

# configuration and workload keys of a sound CPU run: 24 genomes of 3,000
# bases in 3 families, 600 reads from members 0-2 of the first two, and
# k = 11, small enough that the read set's k-mers fill a share of the 4^k
# space and the third family's p-values fall strictly between 0 and 1
TINY = {"genome_bases": 3000, "s": 64, "genomes": 24, "k": 11, "reads": 600,
        "source_families": 2}
# enough distinct read k-mers (~280,000) that cutting the KMV state's
# values to 32 bits moves the cardinality, and with it the p-values inside
# (0, 1), beyond the tolerance: the control's sizes
CONTROL = {**TINY, "reads": 2000}


def _hit_off_by_one(orig):
    def fn(*args, **kw):
        hits = orig(*args, **kw)
        hits[0] += 1
        return hits
    return fn


def _p_value_off(orig):
    def fn(*args, **kw):
        return orig(*args, **kw) * (1 + 1e-8)
    return fn


def _last_batch_lost(orig):
    def fn(*args, **kw):
        batches = list(orig(*args, **kw))
        yield from batches[:-1]
    return fn


# (module, attribute, wrapper): the program broken where the judge must notice
FAULTS = [
    (engine, "_hits_from_bitmap", _hit_off_by_one),
    (oracle_compare, "screen_p_value_vec", _p_value_off),
    (engine, "_device_batches", _last_batch_lost),
]
