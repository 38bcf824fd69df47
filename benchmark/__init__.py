"""The benchmark of `rambl_tpu_torch` on one NVIDIA H100: `run.py` runs one
cell of `BENCHMARK.json` once. See `harness/` for the general runners,
`reference/` for the plain reference that decides `correct`, `configs/`,
`workloads/` and `metrics/` for the data and readers found by name."""
