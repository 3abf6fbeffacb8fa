"""Multi-device execution of the port (counterpart of the JAX package's
parallel/): the sketch DB sharded along the genome axis, all-vs-all tiles
computed while column blocks travel around a ring of positions (kernels
K3/K4 at every step), and read screening data-parallel with partial hit
state merged collectively (kernel K1 per batch).  Inside one process the
host moves blocks between positions; across processes torch.distributed
does (gloo or NCCL).
"""

from .mesh import local_mesh, initialize_distributed  # noqa: F401
from .allvsall import (dist_sharded, dist_sharded_hostring,  # noqa: F401
                       ring_all_vs_all_counts)
from .screen import screen_sharded  # noqa: F401
