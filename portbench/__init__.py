"""Benchmark of the PyTorch/CUDA port ``repro_torch`` (see ``run.py``).

The yardstick lives here and nowhere in the program: traffic generation
(``gen.py`` over ``traffic/*.json``), the deployments (``configs/*.json``)
and their graph generators (``generators/``), the drivers of each mix
(``drivers/``), the plain reference (``reference/``), the comparison that
decides ``correct`` (``check.py``), the reduction of traces
(``trace.py``) and one reader per metric (``metrics/``), each found by
name (``discover.py``).  ``program.py`` is the one module that imports
the program.
"""
