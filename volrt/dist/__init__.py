"""Multi-chip / multi-host execution (new capability; no reference analog).

The reference is strictly single-GPU (one ``cudaGLSetGLDevice`` call,
reference: VolR.cpp:197); its only parallelism is the intra-kernel thread
grid. Here the same axis — the pixel grid — is scaled one level up: pixel
rows are sharded across a ``jax.sharding.Mesh`` of devices (the GPUs of a
host, joined by NVLink), volume + TF are replicated, and parameter gradients
are all-reduced by XLA-inserted ``psum`` during the backward pass.
"""
from volrt.dist.mesh import make_mesh, replicated, tiles_sharding  # noqa: F401
