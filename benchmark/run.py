"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout, on a machine with the cards the cell asks for.
The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``; with ``--trace 1``
``breakdown``; last, ``checks``: each number that decided ``correct``
beside its limit, also the last lines of standard error). With ``--trace
0`` the metrics are the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones. ``--control tf32|fp8`` puts the plain reference, in that
precision, in the program's place (the control that each limit was shown
to catch); the benchmark's own runs never pass it.

It exits with another code than 0, and prints no result, without CUDA or
with fewer cards than the cell asks for, without the program under test,
or when JAX, flax or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"


def main(argv=None) -> int:
    p = argparse.ArgumentParser("benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("tf32", "fp8"), default=None)
    args = p.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    # caches at fixed places inside the checkout; no JAX behind a library;
    # one thread per library pool, so that no idle pool spins against the
    # loop's own threads
    os.environ["USE_FLAX"] = "0"
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[k] = "1"
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    try:
        import snipper_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program under test is missing: {e}", file=sys.stderr)
        return 2
    import torch

    from benchmark import harness

    cell = harness.workload(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), device, args.control,
                              t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name} {float(c['value'])!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
