"""miekki_tpu_torch — the PyTorch/CUDA port of miekki_tpu.

Genomic MinHash sketching for an NVIDIA H100: FASTA/FASTQ → 2-bit codes
→ canonical ntHash k-mer windows (CUDA kernel K1; K2 fuses hash,
threshold and candidate reduction on the `fused` strategy) → bottom-s
sketches → sketch index (raw, or compact 32-bit codes) → all-pairs
intersection counts (CUDA kernel K3; K4 on compact indexes) → Mash
distance / ANI TSV; read sets are screened against an index (K1 hashes
the reads) for per-genome containment.  Indexes and TSVs are
byte-identical to miekki_tpu's.
Importing the package needs no CUDA; kernels are built at first launch.
"""

from .params import HASH_VERSION, SketchParams  # noqa: F401


def __getattr__(name):
    # Lazy: importing the package must not pull in the engine.
    if name in ("build_index", "build_index_per_record", "sketch_file",
                "dist", "dist_iter", "dist_tsv_write", "screen", "rows_to_tsv"):
        from . import engine

        return getattr(engine, name)
    if name in ("SketchIndex", "index_to_device"):
        from .index import store

        return getattr(store, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__version__ = "0.1.0"
