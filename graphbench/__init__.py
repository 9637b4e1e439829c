"""The benchmark of the graph engine's PyTorch and CUDA port (``repro_torch``).

One cell (a graph deployment under a traffic mix, both named in
``BENCHMARK.json``) runs once per call of ``graphbench/run.py``.  Everything
that measures lives here and is found by name:

  * ``configs/<config>.json``  -- a deployment: generator, scale, edge
    direction, weights, slack, the service's settings and the guarantees it
    gives;
  * ``generators/<name>.py``   -- the graph generator a configuration names;
  * ``weights/<name>.py``      -- the weight draw a configuration names;
  * ``traffic/<mix>.json``     -- a traffic mix, read by the traffic driver its
    ``kind`` names (``drivers.DRIVERS``);
  * ``streams/<name>.py``      -- the update stream a traffic mix names;
  * ``limits/<cell>.json``     -- the limits of the numbers that decide
    ``correct`` in that cell;
  * ``metrics/<metric>.py``    -- one reader per per-layer metric.

The plain reference (``reference/``) imports nothing of the program.  No
module here imports JAX or the JAX package.
"""
