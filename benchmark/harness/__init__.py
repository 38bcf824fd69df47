"""The benchmark's general code: the deployment's database and sample, the
traffic runners, the trace and the comparisons."""
