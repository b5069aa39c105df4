"""The benchmark of ``resnetc_tpu_torch`` on one NVIDIA H100.

``python -m gpubench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once (``run``).  Everything that belongs
to one configuration, traffic mix or metric is a file of its own, found by
its name: ``configs/<config>.json``, ``traffic/<mix>.json`` with its client
in ``loops/<loop>.py``, ``metrics/<metric>.py``.  The yardstick lives here:
the plain reference (``references/``), the inputs (``inputs``), the work
counts and peaks (``work``), the reading of the profiler (``trace``), the
comparison that decides ``correct`` (``check``) and its control
(``control``).  Nothing here imports JAX or the JAX package, and the
reference imports nothing of the program.
"""
