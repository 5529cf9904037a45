"""Framework-wide constants.

These mirror the operating constants of the reference renderer
(`/root/reference/VolumeRendering/RaycasterBase.h:12-16`, `common.h:16`) so that
parity between the JAX golden renderer and the reference algorithm is
well-defined; everything else about the implementation is plain JAX.
"""

# 1D transfer-function LUT resolution (reference: RaycasterBase.h:15).
TF_SIZE = 128
# Ratio between the 256 possible uint8 sample values and TF_SIZE buckets
# (reference: RaycasterBase.h:16).
TF_RATIO = 256 // TF_SIZE

# Empty-space-leaping min/max block grid is ESL_VOLUME_DIMS^3 blocks
# (reference: RaycasterBase.h:12-14).
ESL_VOLUME_DIMS = 32
ESL_MIN_BLOCK_SIZE = 8

# Number of renderer rungs in the ladder: the golden reference and the
# batched XLA march (the reference ladder has five, common.h:16).
RENDERER_COUNT = 2

# Default render parameters (reference: RaycasterBase.cpp:9-20).
DEFAULT_RAY_STEP = 0.06
DEFAULT_RAY_THRESHOLD = 0.95
DEFAULT_LIGHT_KD = 0.6

# Default interactive viewport (reference: ViewBase.h:11-12).
DEFAULT_WIN_WIDTH = 799
DEFAULT_WIN_HEIGHT = 715

# Shading gates (reference: CPURenderer.cpp:32, RaycasterBase.h:90).
SHADE_ALPHA_GATE = 0.05
SHADE_KD_GATE = 0.01
# Offset of the secondary shading tap toward the light
# (reference: RaycasterBase.h:91, GPURenderer4.cu:44-46).
SHADE_LIGHT_OFFSET = 0.01

# Gradient-Phong shading option (new capability; upgrades the reference's
# one-tap diffuse for BASELINE config 4): ambient floor, specular weight
# and exponent of the Blinn-Phong model over central-difference normals.
PHONG_KA = 0.3
PHONG_KS = 0.2
PHONG_SHININESS = 16.0
