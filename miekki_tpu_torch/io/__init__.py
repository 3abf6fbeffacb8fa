"""Host-side I/O: FASTA/FASTQ reading, 2-bit encoding, native fast path."""

from . import encode, reader  # noqa: F401
