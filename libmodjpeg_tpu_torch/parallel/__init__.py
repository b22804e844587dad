"""Batching and sharding layer (PyTorch port of libmodjpeg_tpu.parallel).

Image batches split over a mesh's "batch" axis, and the MCU block grid of
one huge image splits into row slabs over the mesh, with the rows an
overlay crossing slab borders needs gathered and written back explicitly.
One process drives all of its local devices; ``init_distributed`` joins a
multi-process group for multi-host corpus runs.
"""

from .mesh import make_mesh, batch_sharding, grid_sharding  # noqa: F401
from .batch import compose_batch, BatchComposer  # noqa: F401
from .grid import effects_sharded, compose_sharded  # noqa: F401
from .session import GridSession, init_distributed  # noqa: F401
