"""The benchmark of rust_local_rag_tpu_torch on NVIDIA cards.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json in this process: it builds the cell's
system from the seed, warms the cell's shapes, measures for --seconds,
checks what the window produced against the plain reference, and prints,
as its last line on standard output, one JSON object: correct, attempted,
failed, metrics (the end-to-end metrics, or with --trace 1 the per-layer
ones), device, with --trace 1 breakdown, and last `compared`, each number
that decides `correct` beside its limit (also the last lines on standard
error). It exits 1 and prints no result without enough CUDA devices, on
any error, or when JAX or the JAX package was loaded.
"""

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        import torch

        from harness import runner

        chips = runner.load_cell(args.workload).chips
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"this cell needs {chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
            return 1
        out, lines = runner.run(args.workload, args.seed, args.seconds, bool(args.trace), T_PROCESS)
    except Exception:  # noqa: BLE001 - any failure ends the run without a result
        traceback.print_exc()
        return 1
    loaded = runner.forbidden_modules()
    if loaded:
        print(f"the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 1
    print(json.dumps(lines), flush=True)
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # every process and thread the run started has ended; leave without the
    # interpreter's teardown, whose messages would follow the compared lines
    os._exit(code)
