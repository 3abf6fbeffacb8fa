"""Share of the screen jobs' spans in which the card ran no kernel, copy or
memset (torch.profiler trace of the window)."""

from benchmark.yardstick.readers import idle_share


def read(run):
    return idle_share(run)
