"""PyTorch/CUDA port of the TDR pattern-constrained reachability engine.

The main path: ``graph.Graph`` -> ``tdr_build.build_index`` ->
``tdr_query.answer_batch`` (boolean PCR queries), with
``lcr.answer_lcr_batch`` on top.  Entry points run on the CUDA card by
default and raise when there is none; pass ``device="cpu"`` to run on the
CPU, where the hand-written kernels' plain PyTorch versions stand in.
Importing the package builds nothing: the kernels are compiled with
``nvcc`` at their first launch (``kernels/_build.py``).

The seed's LM substrate rides along: ``configs``, ``models``, ``train``,
``data``, ``checkpoint`` and ``launch/train.py`` (plain PyTorch, no
hand-written kernel), with params laid out as the reference's.

The JAX package ``repro`` is the reference; this package imports none of
it, nor JAX.
"""
