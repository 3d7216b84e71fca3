"""The benchmark of gpqhe_tpu_torch on NVIDIA GPUs: one run of one cell.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the result as the last line of standard
output (one JSON object), and each number compared beside its limit as the
last lines of standard error.  Exits non-zero without a result where there
is no CUDA device, fewer than the cell asks for, or where the process has
loaded JAX or the JAX package.  The cells, configurations, traffic mixes and
metrics are found by name: README.md.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "gpqhe_tpu")


def environment(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port builds its CUDA libraries into build/kernels/ itself), and one
    thread for the host's numerical libraries: the load is one process."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(root, "build", "gpubench_cache", sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def loaded_forbidden() -> list[str]:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (gpqhe_tpu_torch is not gpqhe_tpu)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment(ROOT)
    sys.path.insert(0, ROOT)

    import torch
    torch.set_num_threads(1)

    from gpubench import harness

    cell = harness.Cell.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"gpubench: {args.workload} needs {cell.chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    found = loaded_forbidden()
    if found:
        print(f"gpubench: the process loaded {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
