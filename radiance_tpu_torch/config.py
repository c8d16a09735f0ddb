"""Global configuration constants.

Mirrors the reference's compile-time knobs (reference: radiance/src/bvh.h:9
MAX_LEAF_PRIM_SIZE, radiance/shader/data.cl:80-83 type tags).  A copy of
radiance_tpu/config.py without the TPU VMEM budget and the walk's
stack size (the walk is stackless).
"""

# --- BVH build ---------------------------------------------------------------
# Reference builds a leaf when a work set has < 8 primitives
# (reference: bvh.cpp:55, bvh.h:9).
MAX_LEAF_PRIM_SIZE = 8

# Device-side leaf bundle width: every leaf is normalized to hold at most this
# many primitives (oversized no-SAH-improvement leaves get median-split).  Keeps
# leaf intersection a fixed-shape 8-wide vector op on TPU.
LEAF_WIDTH = 8

# --- Acceleration structure type tags (reference: data.cl:80-86) -------------
TYPE_INST = 1
TYPE_TRIG = 2
TYPE_TOP_AS = 1
TYPE_BOT_AS = 2

# Leaf flag on the node count word (reference: bvh.cpp:486, data.cl:98-99).
LEAF_FLAG = 0x80000000
COUNT_MASK = 0x7FFFFFFF

# Rays are traced by the walk (ops/traversal.py) in chunks of this many, to
# bound its per-ray state.
DEFAULT_RAY_CHUNK = 1 << 17  # 131072 rays

# --- Images ------------------------------------------------------------------
CHANNEL = 4  # RGBA, reference: radiance.h:84

# Sampler modes (values chosen to be stable across the framework; the
# reference forwards OpenCL enums, radiance.h:94-112).
ADDRESS_CLAMP_TO_EDGE = 0
ADDRESS_CLAMP = 1
ADDRESS_REPEAT = 2
ADDRESS_MIRRORED_REPEAT = 3
FILTER_NEAREST = 0
FILTER_LINEAR = 1
