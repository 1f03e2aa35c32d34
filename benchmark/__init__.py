"""The benchmark of ``gentun_tpu_torch`` on one NVIDIA H100: see ``run.py``.

Everything here is the yardstick: traffic generation, the reduction from
traces and spans to metrics, the table of peaks, the functions that count
the work a genome needs, and the plain reference that decides ``correct``.
From the program it takes only the entry it drives
(``GeneticCnnModel.cross_validate_population``), its telemetry spans and
its kernels' names.
"""
