"""volrt — differentiable volume raycasting framework in JAX.

A from-scratch JAX rebuild of the capabilities of MiroBeno/Volume-Rendering:
PVM/DDS/RAW volume loading, orbit camera, 1D transfer functions,
front-to-back raycasting with early-ray-termination and empty-space-leaping,
a golden JAX reference renderer and a batched XLA renderer, gradients
w.r.t. voxels and TF, multi-device sharded rendering/training, a benchmark
harness, and a CLI.
"""

__version__ = "0.1.0"

from volrt.constants import (  # noqa: F401
    ESL_MIN_BLOCK_SIZE,
    ESL_VOLUME_DIMS,
    RENDERER_COUNT,
    TF_RATIO,
    TF_SIZE,
)
from volrt.core.types import (  # noqa: F401
    Raycaster,
    View,
    Volume,
    make_raycaster,
)
