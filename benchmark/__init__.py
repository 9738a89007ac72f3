"""The benchmark of `ttl_tpu_torch` on one NVIDIA H100 card.

`python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` and prints one JSON line.
Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by its name:

- `configs/<config>.json`: the model and its test-time-adaptation settings;
- `traffic/<traffic>.json`: the mix, read by the driver it names
  (`traffic/<driver>.py`);
- `workloads/<cell>.json`: the cell's check (sample, limits) and trace;
- `metrics/<metric>.py`: the reader of one per-layer metric.

`harness/` holds the yardstick (images, trace reading, operation counts,
peaks, the comparison that decides `correct`) and `reference/` the plain
float32 model that the program's answers are held to.
"""
