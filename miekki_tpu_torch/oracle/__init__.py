"""Pure-numpy CPU oracle — the bit-exact parity anchor for the device path
(a copy of miekki_tpu.oracle, held to it by the port's tests).

It implements the frozen algorithmic contracts of SURVEY.md §2.1, which the
acceptance configs are checked against (SURVEY.md §4).
"""

from . import compare, nthash, sketch  # noqa: F401
