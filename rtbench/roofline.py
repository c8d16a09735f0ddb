"""The least-work count of the wave cells and the card's peaks.

The bytes and FLOPs any tracer of the three waves needs, whatever
implements it: each ray's origin and direction read once (24 B), each
closest-hit record written once (t, prim, b1, b2: 16 B), each shadow
result written once (4 B), the scene's vertices read once a wave (36 B a
triangle); one ray-triangle test a ray (44 FLOPs).  Peaks: NVIDIA's H100
SXM data sheet, dense float32 outside the tensor cores, at 700 W.
"""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
RAY_BYTES = 24
HIT_BYTES = 16
SHADOW_BYTES = 4
TRI_BYTES = 36
FLOPS_PER_RAY = 44


def wave_bytes(n, n_tris):
    """Bytes of one iteration: three waves of n rays, two closest-hit
    and one shadow."""
    return (3 * n * RAY_BYTES + 2 * n * HIT_BYTES + n * SHADOW_BYTES
            + 3 * n_tris * TRI_BYTES)


def wave_flops(n):
    return 3 * n * FLOPS_PER_RAY


def wave_least_s(n, n_tris):
    """The least seconds of one iteration: the larger of its bytes at the
    memory peak and its FLOPs at the float32 peak."""
    return max(wave_bytes(n, n_tris) / HBM_BYTES_PER_S,
               wave_flops(n) / FP32_FLOPS)
