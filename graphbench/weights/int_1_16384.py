"""Integer weights uniform in [1, MaxIntWeight], SSCA#2's, with
MaxIntWeight = 2^14 at scale 14: exact in float32."""
import numpy as np

MAX_INT_WEIGHT = 1 << 14


def draw(rng, size: int):
    return rng.integers(1, MAX_INT_WEIGHT + 1, size).astype(np.float32)
