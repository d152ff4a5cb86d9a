"""Global configuration constants.

Mirrors the reference's compile-time knobs (reference: radiance/src/bvh.h:9
MAX_LEAF_PRIM_SIZE, radiance/shader/radiance.cl:38-39 stack sizes,
radiance/shader/data.cl:80-83 type tags) plus the wavefront engine's
fixed-shape layout parameters.
"""

# --- BVH build ---------------------------------------------------------------
# Reference builds a leaf when a work set has < 8 primitives
# (reference: bvh.cpp:55, bvh.h:9).
MAX_LEAF_PRIM_SIZE = 8

# Device-side leaf bundle width: every leaf is normalized to hold at most this
# many primitives (oversized no-SAH-improvement leaves get median-split).  Keeps
# leaf intersection a fixed-shape 8-wide vector op.
LEAF_WIDTH = 8

# --- Acceleration structure type tags (reference: data.cl:80-86) -------------
TYPE_INST = 1
TYPE_TRIG = 2
TYPE_TOP_AS = 1
TYPE_BOT_AS = 2

# Leaf flag on the node count word (reference: bvh.cpp:486, data.cl:98-99).
LEAF_FLAG = 0x80000000
COUNT_MASK = 0x7FFFFFFF

# --- Traversal ---------------------------------------------------------------
# The reference walks per-ray stacks of 8 (TLAS) and 100 (BLAS) entries
# (reference: radiance.cl:38-39); the wavefront walk is stackless (escape
# indices, ops/traversal.py).  Waves larger than this many rays are traced
# as a lax.map over chunks, which bounds the walk's per-ray state (about
# 100 bytes per ray) and lets finished chunks retire early.
DEFAULT_RAY_CHUNK = 1 << 17

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
