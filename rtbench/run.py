"""The benchmark of radiance_tpu_torch (the PyTorch and CUDA port) on
one NVIDIA card.

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s>
                           --trace <0|1>

Run from the root of a checkout.  The cell (BENCHMARK.json "workloads")
names a configuration and a traffic mix; the harness finds their files
by name (harness.py), builds the scene and warms up (set-up), measures
for --seconds, checks a sample of what the window produced against the
plain reference (reference/), and prints one JSON line last: correct,
attempted, failed, metrics, device[, breakdown], and the numbers it
compared with their limits.  --trace 1 runs the window under
torch.profiler and reports the cell's per-layer metrics instead of its
end-to-end ones.

Exits 2 without enough CUDA cards, 3 if a forbidden module (JAX, the
JAX package, bench.py, chip_smoke.py) was loaded, 1 on any other error;
in each case without a result line.

--control <name> (not a benchmark run) replaces the program's answers
by the reference's own computed one precision lower (bfloat16), judged
as a run is: it must come out not correct.  --cpu runs on the CPU for
the CPU tests, with the plain versions of the program's kernels.
"""

import argparse
import gc
import os
import sys
import time

T_START = time.perf_counter()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from rtbench import harness, launches  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("bf16",), default=None)
    ap.add_argument("--cpu", action="store_true")
    return ap.parse_args(argv)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def device_info(torch, dev, chips, peak):
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": int(peak)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips, "memory_peak_bytes": int(peak)}


def card_line():
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def traced_window(run, driver, state, prof, torch):
    """The window under torch.profiler; a profile that lost the program's
    kernel records is taken again while the run has time (prof.TRIES)."""
    setup_spans = len(run.spans)
    for i in range(prof.TRIES):
        del run.spans[setup_spans:]     # a retake drops the lost window's
        run.events = {}
        launches.reset()
        with prof.device_profile() as p:
            t0 = time.perf_counter_ns()
            run.window = driver.window(run, state, run.seconds)
        recs = prof.records(p)
        del p
        lost = launches.lost_records(recs)
        log(f"profile {i + 1}: {len(recs)} device records, "
            f"lost program records: {lost}")
        if not lost or time.perf_counter() - T_START > 150:
            break
    port = [r for r in recs if not prof.is_torch(r[0])]
    tor = [r for r in recs if prof.is_torch(r[0])]
    run.profile = dict(
        records=recs, window_s=run.window["window_s"],
        busy_s=prof.busy_s(recs),
        port_s=sum(r[2] for r in port) / 1e9,
        torch_s=sum(r[2] for r in tor) / 1e9, lost=lost, t0_ns=t0)
    log("program kernels: " + ", ".join(
        f"{n[:60]} {s:.6f}s" for n, s in prof.by_name(port, 8)))
    return dict(device_ops=prof.by_name(recs),
                idle_gaps=prof.label_gaps(recs, run.spans, t0))


def main(argv=None):
    args = parse(argv)
    bench = harness.benchmark()
    cell = harness.workload(bench, args.workload)
    import torch
    if args.cpu:
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell["chips"]:
            log(f"rtbench: {args.workload} needs {cell['chips']} CUDA "
                f"card(s); torch.cuda.is_available() is "
                f"{torch.cuda.is_available()}")
            return 2
        dev = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = harness.load_json(harness.find("configs", cell["config"], ".json"))
    traffic = harness.load_json(harness.find("traffic", cell["traffic"],
                                             ".json"))
    limits = harness.load_json(harness.find("limits", args.workload,
                                            ".json"))
    driver = harness.load_module("drivers", traffic["driver"])
    run = harness.Run(args.workload, cfg, traffic, args.seed, args.seconds,
                      bool(args.trace), dev)
    if dev.type == "cuda":
        log(f"card: {card_line()}")

    if args.control:
        state = driver.control_setup(run)
        correct, numbers, attempted = driver.control(run, state, limits)
        return finish(run, bench, args, torch, dev, cell, correct, attempted,
                      0, numbers, None)

    state = driver.setup(run)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    run.setup_s = time.perf_counter() - T_START
    log(f"set-up {run.setup_s:.3f} s: " + ", ".join(
        f"{n} {run.span_s(n):.3f}" for n in dict.fromkeys(
            s[0] for s in run.spans)))
    breakdown = None
    if args.trace:
        from rtbench import prof
        breakdown = traced_window(run, driver, state, prof, torch)
    else:
        launches.reset()
        run.window = driver.window(run, state, args.seconds)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    run.counters.update(launches.counts())
    log(f"window: {run.window['window_s']:.3f} s, "
        f"{run.window['done']} {run.window['unit']}, live rays of the "
        f"last bounce and shadow waves {run.window.get('live', '-')}, "
        f"counters {run.counters}")
    kept = driver.release(run, state)
    del state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    correct, numbers = driver.check(run, kept, limits)
    log(f"check {time.perf_counter() - t_check:.3f} s")
    return finish(run, bench, args, torch, dev, cell, correct,
                  run.window["done"], 0, numbers, breakdown, peak)


def finish(run, bench, args, torch, dev, cell, correct, attempted, failed,
           numbers, breakdown, peak=0):
    metrics = {}
    if not args.control:
        for m in harness.cell_metrics(bench, args.workload, bool(args.trace)):
            value = harness.load_module("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = device_info(torch, dev, cell["chips"], peak)
    if args.trace and run.profile:
        device["busy_s"] = run.profile["busy_s"]
        device["window_s"] = run.profile["window_s"]
    bad = harness.forbidden_modules()
    if bad:
        log(f"rtbench: forbidden modules loaded: {bad}")
        return 3
    log(f"correct: {bool(correct)}")
    for name, value, limit in numbers:
        log(f"checked {name}: {value!r} (limit {limit!r})")
    print(harness.result_line(correct, attempted, failed, metrics, device,
                              numbers, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
