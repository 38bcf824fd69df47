"""What the benchmark loads: no module whose top-level name is `jax`,
`jaxlib`, `flax` or `rambl_tpu` (compared whole: the port's own name
begins with `rambl_tpu`), and a reference that imports nothing of the
port."""

import ast
import json
import os
import subprocess
import sys

from benchmark.harness.spec import BENCH_DIR, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "rambl_tpu"}
REF_DIR = os.path.join(BENCH_DIR, "reference")

DRIVE = """
import contextlib, json, sys, tempfile
import torch
from benchmark import run
from benchmark.harness import panel
from benchmark.harness import spec
from benchmark.harness.cells import Context
from benchmark.harness import spans, trace
panel.CACHE_DIR = tempfile.mkdtemp()
cfg = {"panel": {"n_species": 3, "refs_per_species": 2, "leaf_per_ref": False,
                 "ref_len_max": 2048, "panel_seed": 1},
       "sample": {"n_reads": 300, "abundance_sigma": 1.0, "read_len": 100,
                  "read_len_max": 128, "sub_error": 0.004,
                  "indel_error": 0.0005},
       "settings": {"batch_size": 256, "sw_rows": 104}}
tr = {"kind": "stream", "rate_metric": "reads_per_s", "unit": "reads",
      "check_reads": 20}
d = spec.runner("stream")(Context("t", "t", cfg, tr, 1, torch.device("cpu"),
                                  log=lambda m: None))
d.setup()
d.window(0.0, contextlib.nullcontext)
assert all(v == 0 for v, _ in d.check().values())
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True,
                         env=dict(os.environ, USE_FLAX="0"))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_cells_a_run_loads_no_jax_and_no_jax_package():
    mods = _modules(DRIVE)
    assert "rambl_tpu_torch" in mods and "benchmark" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_cells_reference_imports_nothing_of_the_port():
    names = sorted(f[:-3] for f in os.listdir(REF_DIR) if f.endswith(".py"))
    code = ("import json, sys\n"
            + "".join(f"import benchmark.reference.{n}\n" for n in names)
            + "print(json.dumps(sorted({m.split('.')[0] "
              "for m in sys.modules})))\n")
    mods = _modules(code)
    assert not mods & (FORBIDDEN | {"rambl_tpu_torch"})
    allowed = {"__future__", "dataclasses", "numpy", "torch", "benchmark"}
    for n in names:
        with open(os.path.join(REF_DIR, n + ".py")) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or "").split(".")[0]}
                if node.module and node.module.startswith("benchmark"):
                    assert node.module.startswith("benchmark.reference"), n
            else:
                continue
            assert tops <= allowed, (n, tops)
