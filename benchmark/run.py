"""Run one cell of the benchmark of `rambl_tpu_torch` once, on one machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or `python -m benchmark.run ...` from the repository root). The run loads
the cell's deployment, makes its sample from the seed, warms up, measures a
closed loop of whole units of work (stream passes or leaf blocks) for at
least `--seconds`, checks what the timed path produced against the plain
reference, and prints one JSON line last on standard output. With
`--trace 0` its metrics are the cell's end-to-end metrics, with `--trace 1`
its per-layer metrics, read from torch.profiler over the window.

`--control 1` puts the reference in the program's place at the next
narrower integers for the check (the control of the comparison: it must
come out not correct).

A cell of `chips` cards runs on the first `chips` CUDA cards. Its
`peak_gb` is the fullest card's peak over the window, `memory_peak_bytes`
the fullest card's peak with set-up included, and the traced `busy_s` the
mean of the cards' busy times (`harness/trace.py`).

The run needs a CUDA card (it never falls back to the CPU) and fails when
any of `jax`, `jaxlib`, `flax` or `rambl_tpu` is loaded once the window
has closed. Caches (the database, torch extensions, Triton) live under
`benchmark/_cache/`, the port's kernel build under `rambl_tpu_torch/_build/`,
both inside the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "rambl_tpu")
#: a traced window lost records is run again only if it can end by then
TRACE_DEADLINE_S = 300


def _process_start() -> float:
    """The epoch time at which this process started."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(ln.split()[1]) for ln in f
                         if ln.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


T_START = _process_start()


def _log(msg: str) -> None:
    print(f"[{time.time() - T_START:8.1f} s] {msg}", file=sys.stderr,
          flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = os.path.join(_HERE, "_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    if _REPO not in sys.path:
        sys.path.insert(0, _REPO)

    import torch

    from benchmark.harness import spec as S

    cell = S.cell(S.load_spec(), args.workload)
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell["chips"]):
        print(f"no CUDA card for {args.workload}: cuda available "
              f"{torch.cuda.is_available()}, {torch.cuda.device_count()} "
              f"visible, {cell['chips']} needed", file=sys.stderr)
        return 3
    line = run(args, [torch.device("cuda", i)
                      for i in range(cell["chips"])])
    if line is None:
        return 4
    print(json.dumps(line), flush=True)
    return 0


def run(args, devs, root: str = _REPO, log=_log):
    """Everything of a run after the look for a card, on `devs` (the cell's
    cards, or one device): the result line as a dict, or None when a
    forbidden module was loaded. `root` is the directory that holds
    BENCHMARK.json and the benchmark's files."""
    import contextlib

    import torch

    from benchmark.harness import spec as S
    from benchmark.harness.cells import Context, sync

    spec = S.load_spec(os.path.join(root, "BENCHMARK.json"))
    cell = S.cell(spec, args.workload)
    entry = S.config_entry(spec, cell["config"])
    config = S.read_json(entry["file"], root)
    bench_dir = os.path.join(root, os.path.basename(_HERE))
    with open(S.traffic_file(cell["traffic"], bench_dir)) as f:
        traffic = json.load(f)
    devs = [torch.device(d) for d in
            (devs if isinstance(devs, (list, tuple)) else [devs])]
    dev = devs[0]
    cuda = dev.type == "cuda"
    if cuda:
        from rambl_tpu_torch.device import card_line

        for d in devs:
            log(f"{args.workload} seed {args.seed} on {card_line(d)}")
    ctx = Context(cell=args.workload, config_name=cell["config"],
                  config=config, traffic=traffic, seed=args.seed, device=dev,
                  log=log, devices=tuple(devs))
    runner = S.runner(traffic["kind"], bench_dir)(ctx)
    runner.setup()
    sync(ctx)

    def peaks():
        """Each card's peak allocation since its last reset."""
        return [torch.cuda.max_memory_allocated(d) if cuda else 0
                for d in devs]

    setup_peaks = peaks()
    if cuda:
        for d in devs:
            torch.cuda.reset_peak_memory_stats(d)
    setup_s = time.time() - T_START
    log(f"set-up done in {setup_s:.1f} s; window of {args.seconds} s")

    trace = None
    if args.trace:
        from benchmark.harness.spans import K1Launches
        from benchmark.harness.trace import traced

        with K1Launches() as k1:
            work, trace = traced(lambda span: runner.window(args.seconds,
                                                            span),
                                 deadline=T_START + TRACE_DEADLINE_S,
                                 devices=devs)
        window_s = trace.window_s
    else:
        t0 = time.perf_counter()
        work = runner.window(args.seconds, contextlib.nullcontext)
        window_s = time.perf_counter() - t0
    window_peaks = peaks()
    peak = max(window_peaks)
    log(f"window: {work} {traffic['unit']} in {window_s:.3f} s")
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return None

    metrics = {}
    if args.trace:
        rec = dict(trace=trace, work=work, k1_launches=k1.launches,
                   window_s=window_s, busy_s=trace.busy_s)
        for m in S.layer_metrics_of(spec, args.workload):
            v = S.reader(m["name"], bench_dir)(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s, "peak_gb": peak / 1e9,
                  traffic["rate_metric"]: work / window_s}
        for m in S.metrics_of(spec, args.workload):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}

    t0 = time.perf_counter()
    compared = runner.check(control=bool(args.control))
    runner.release()
    log(f"check in {time.perf_counter() - t0:.1f} s")
    correct = all(v <= lim for v, lim in compared.values())
    device = {"platform": "gpu" if cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
              "count": cell["chips"],
              "memory_peak_bytes": int(max(map(max, setup_peaks,
                                               window_peaks)))}
    line = {"correct": correct, "attempted": int(work), "failed": 0,
            "metrics": metrics, "device": device}
    if trace is not None:
        device.update(busy_s=trace.busy_s, window_s=trace.window_s)
        line["breakdown"] = {"device_ops": trace.device_ops(),
                             "idle_gaps": trace.idle_gaps()}
    line["compared"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in compared.items()}
    for k, (v, lim) in compared.items():
        print(f"compared {k}: {v} (limit {lim})", file=sys.stderr)
    return line


if __name__ == "__main__":
    sys.exit(main())
