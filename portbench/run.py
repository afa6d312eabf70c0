"""The benchmark of ``fermiflow_tpu_torch``: one run of one cell.

    python3 portbench/run.py --workload gs_n6.persistent_k10 --seed 7 \
        --seconds 10 --trace 0

From the root of a checkout on a machine with an NVIDIA card.  Prints each
number of the correctness check beside its limit as the last lines of
standard error, and one JSON object as the last line of standard output:
``correct``, ``attempted`` and ``failed`` (iterations in the window, and
those whose energy was not finite), ``metrics`` (``--trace 0``: the cell's
end-to-end metrics; ``--trace 1``: its per-layer ones), ``device``,
``breakdown`` (``--trace 1``) and ``compared``.  Exits 2, printing no
result, without a card, with fewer cards than the cell asks for, or when a
module of JAX or of the JAX package has been loaded.  See README.md.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Build and kernel caches at fixed paths inside the checkout: the package's
# kernels build into its own fermiflow_tpu_torch/build/.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(ROOT / ".portbench_cache" / sub)
os.environ["USE_FLAX"] = "0"
# One process with one host thread for PyTorch's CPU operators: the host
# work between replays is small, and a thread pool only adds jitter.
os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = "1"
sys.path[:0] = [str(HERE), str(ROOT)]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    import check
    import harness

    torch.set_num_threads(1)

    spec = harness.cell_spec(ROOT, args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              , file=sys.stderr)
        return 2
    workdir = Path(os.environ.get("TMPDIR", "/tmp")) / (
        f"portbench-{args.workload}-{os.getpid()}")
    try:
        res = harness.run_cell(spec, args.seed, args.seconds,
                               bool(args.trace), "cuda", T0, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        print(f"loaded a module it may not: {', '.join(bad)}", file=sys.stderr)
        return 2
    compared = res.get("compared", {})
    limits = spec["limits"]
    correct = res["failure"] is None and check.verdict(compared, limits)
    if args.trace:
        metrics = {m["name"]: {"value": res["per_layer"][m["name"]],
                               "unit": m["unit"]}
                   for m in spec["per_layer"]
                   if m["name"] in res.get("per_layer", {})}
    else:
        # The window's rate, under the name the cell reports it by:
        # ``iter_ms.k1`` in cells of one iteration a chunk, whose host path
        # spreads their runs wider (PERF.md).
        values = {"iter_ms": res.get("iter_ms"),
                  "iter_ms.k1": res.get("iter_ms"), "setup_s": res["setup_s"]}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"]
                   if values.get(m["name"]) is not None}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": res["memory_peak_bytes"],
              "power": res.get("power")}
    if args.trace and "busy_s" in res:
        device.update(busy_s=res["busy_s"], window_s=res["window_s"])
    line = {"correct": correct, "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": device}
    if args.trace and "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["compared"] = {k: {"value": compared.get(k), "limit": lim}
                        for k, lim in limits.items()}
    print("set-up seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in res.get("setup_parts", {}).items()),
        file=sys.stderr)
    if res["failure"]:
        print(res["failure"], file=sys.stderr)
    for k, lim in limits.items():
        print(f"compared {k}: {compared.get(k)} (limit {lim})",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
