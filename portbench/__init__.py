"""The benchmark of ``deepim_tpu_torch`` on one NVIDIA H100.

``run.py`` runs one cell; ``spec.py`` finds a cell's configuration,
traffic, driver and metric readers by name; ``drivers/`` hold one timed
loop a kind of entry; ``reference/`` is the plain float32 reference that
decides ``correct``; ``flops.py`` and ``roofline.py`` are the yardstick's
arithmetic.  Nothing here imports JAX or the JAX package, and nothing
under ``reference/`` imports the program.
"""
