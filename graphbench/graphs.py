"""The deployments' initial graphs, drawn from a seed.

Frozen under the benchmark's folder, so that a change to the program cannot
move the yardstick, and found by the names a configuration gives:

  * ``generators/<generator>.py`` -- ``draw(config, rng, weight)`` returns
    ``(n, i, j, w)``: the drawn edges ``i -> j`` once each, duplicates and
    self-loops as drawn, in host arrays;
  * ``weights/<weights>.py`` -- ``draw(rng, size)``, the edges' weights;
    the update stream (``streams/<stream>.py``, a traffic mix's) draws an
    inserted edge's weight the same way.

What every generator shares is done here: ``self_loops`` ``"dropped"``
drops them (no other value is taken); ``directed`` ``false`` stores each
edge in both directions (``[i, j]`` then ``[j, i]``, weights ``[w, w]``),
``true`` each arc once.  ``draw`` returns host arrays ``(src, dst, w)``
(int32, int32, float32) of the directed entries, duplicates included: the
loader keeps the last weight of a duplicated key, and the reference does
the same.
"""
from __future__ import annotations

import numpy as np

from . import spec


def weight_draw(config: dict, root: str = spec.HOME):
    """The configuration's ``weight(rng, size)`` function."""
    return spec.load_module(root, "weights", config["weights"]).draw


def draw(config: dict, rng, root: str = spec.HOME):
    """``(n_vertices, src, dst, w)`` of a configuration's initial graph."""
    directed, loops = config["directed"], config["self_loops"]
    if not isinstance(directed, bool):
        raise ValueError(f"directed must be true or false, not {directed!r}")
    if loops != "dropped":
        raise ValueError(f"self_loops must be 'dropped', not {loops!r}")
    gen = spec.load_module(root, "generators", config["generator"])
    n, i, j, w = gen.draw(config, rng, weight_draw(config, root))
    keep = i != j
    i, j, w = i[keep], j[keep], w[keep]
    if not directed:
        i, j = np.concatenate([i, j]), np.concatenate([j, i])
        w = np.concatenate([w, w])
    return n, i.astype(np.int32), j.astype(np.int32), w.astype(np.float32)


def edge_capacity(config: dict, n_entries: int) -> int:
    return int(n_entries * float(config["edge_slack"]))
