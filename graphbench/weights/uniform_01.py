"""Real weights uniform in [0, 1), the Graph500 specification's."""
import numpy as np


def draw(rng, size: int):
    return rng.random(size).astype(np.float32)
