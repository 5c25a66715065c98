"""The benchmark of ``repro_torch``: AdaptiveLoad training of Wan-2.1 video
diffusion transformers on one H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints its result
as the last line of standard output.  Everything that belongs to one
configuration, traffic mix, cell or per-layer metric is a file of its own,
found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the model's sizes, dtype and optimizer;
* ``traffic/<traffic>.json``: the shape mix, its bucket policy and budget;
* ``cells/<workload>.json``: the limits that decide ``correct``;
* ``metrics/<metric>.py``: the reader of one per-layer metric.

Nothing here imports JAX or the JAX package ``repro``; the reference
(``reference/``) imports nothing of ``repro_torch`` either.
"""
