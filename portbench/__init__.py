"""The benchmark of ``carla_garage_tpu_torch`` on one NVIDIA H100.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints its result
line. Everything that belongs to one configuration, traffic mix, cell or
metric sits in a file of its own, found by name:

- ``configs/<config>.json``: the sizes as run, ``reduced`` and
  ``assumed``, the precision and the forward FLOPs per sample;
  ``configs/<config>.py`` builds the program's and the reference's model,
  policy and training step from them;
- ``traffic/<traffic>.json``: the parameters of a traffic mix and the
  driver that runs it (``drivers/<driver>.py``);
- ``metrics/<metric>.py``: the reader of one metric;
- ``limits/<cell>.json``: the limit of each number that decides
  ``correct``, with the readings it was set from;
- ``reference/``: the frozen plain reference (``reference/cgt``), the
  FLOP counter, the kernels' cost counts and the table of peaks.

Nothing here imports JAX or the JAX package.
"""
