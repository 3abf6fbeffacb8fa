"""The `counts` job kind in the benchmark's CPU tests: the sizes of its
sound runs and of its control, and the faults its judge has to notice."""

import miekki_tpu_torch.ops.intersect as intersect

# configuration and workload keys of a sound CPU run
TINY = {"s": 64, "genomes": 16, "tile": 8, "sampled_pairs": 64, "diagonal_pairs": 8}
# large enough for 32-bit codes to collide: the control's sizes
CONTROL = {"s": 2048, "genomes": 24, "tile": 8, "sampled_pairs": 64, "diagonal_pairs": 8}


def _alter_tile(orig):
    def fn(rows, cols, s):
        out = dict(orig(rows, cols, s))
        out["shared_in_x"] = out["shared_in_x"].clone()
        out["shared_in_x"][0, -1] += 1  # one count altered where it is made
        return out
    return fn


def _half_tile(orig):
    def fn(rows, cols, s):
        out = dict(orig(rows, cols, s))
        for key in ("shared_in_x", "union_size", "inter_full"):
            out[key] = out[key].clone()
            out[key][out[key].shape[0] // 2:] = 0  # half of the tile's rows left out
        return out
    return fn


# (module, attribute, wrapper): the program broken where the judge must notice
FAULTS = [
    (intersect, "tile_counts", _alter_tile),
    (intersect, "tile_counts", _half_tile),
]
