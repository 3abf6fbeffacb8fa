"""Gbase a second of the FASTA parse alone: the reader and packing calls
that engine.build_index makes (8 threads over the files), timed by the
benchmark on the host clock over the job's files after the window."""

from concurrent.futures import ThreadPoolExecutor


def read(run):
    from miekki_tpu_torch.io import encode, reader

    k = run.config["k"]

    def parse(path):
        return encode.pack_records(reader.read_genome_codes(path), k)

    def once():
        with ThreadPoolExecutor(max_workers=8) as ex:
            for _ in ex.map(parse, run.state["paths"]):
                pass

    return run.state["gbase"] / run.timed("parse", once)
