"""The `stripe` job kind in the benchmark's CPU tests: the sizes of its
sound runs and of its control, and the faults its judge has to notice."""

import miekki_tpu_torch.ops.intersect as intersect
import tiny

# configuration and workload keys of a sound CPU run: s = 64 on lanes of 128
# (every DB block a padded copy of the planes), 4 stripes of 8 rows, and
# more sampled pairs than a stripe has, so one altered count is seen
TINY = {"s": 64, "genomes": 32, "rows_per_job": 8, "tile": 8, "sampled_pairs": 512,
        "self_pairs": 4}
# wide enough for distinct values of two rows to share a 32-bit code, so
# compact counts differ from the raw values' counts: the control's sizes
CONTROL = {"s": 8192, "genomes": 16, "rows_per_job": 8, "tile": 8, "sampled_pairs": 64,
           "self_pairs": 4}

# (module, attribute, wrapper): the counts kind's two faults, one count
# altered and half a tile's rows zeroed, planted in K4's entry
FAULTS = [(intersect, "tile_counts_compact", fault)
          for _, _, fault in tiny.kind("counts").FAULTS]
