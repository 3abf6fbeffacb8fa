"""Host milliseconds a million TSV rows of the dist jobs' p-values: the
program's `dist.pvalue` spans (the chance p-value of each pair through the
incomplete beta, and its text) over the rows that `dist.format` counts."""

from benchmark.yardstick import spans


def read(run):
    return spans.per(spans.seconds("dist.pvalue"), spans.count("dist.format", "rows"), 1e9)
