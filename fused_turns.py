"""Times the fused log-likelihood of this checkout against another checkout
of the repository on one NVIDIA GPU, in turns.

The fused path is ``gp_loglik``'s value and gradient at J <= 4.  Each
checkout runs in its own process, in the order other, this, this, other;
the other is usually the parent commit, unpacked with ``git archive`` into
a directory git ignores (``_checkout/``).  A turn imports that checkout's
``celerite2_torch`` and measures it with this checkout's ``chip_smoke.py``
helpers, on its benchmark data (SHOTerm, J = 2; config5's SHO mixture,
J = 4):

* evals/s of 20 chained value+gradient steps at N = 1e5 in float64 and
  float32, and of 5 at J = 4, N = 1e6 (config5's own size) with the peak
  device memory (``chip_smoke.steps_per_s``);
* ``torch.profiler`` over 3 evaluations at N = 1e5, float64: device kernels
  per evaluation, device busy time, idle share, the device time of each of
  this repository's kernels and of the rest, the PyTorch glue
  (``chip_smoke.profile_eval``);
* the structured factor adjoint's kernels K4 and K5 alone and together, at
  J = 3, 4, N = 1e5 and 1e6, 1 and 64 chains, float64 and float32, with
  each device kernel's time under the profiler (``chip_smoke.frev_times``).

    python3 fused_turns.py _checkout/parent

Writes one JSON object per turn to ``chiprun_out/fused_turns.jsonl`` and
prints each.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
OUT = HERE / "chiprun_out" / "fused_turns.jsonl"


def turn(root):
    """One turn: the measurements of ``root``'s package, as a dict."""
    sys.path.insert(0, str(root))
    os.chdir(root)
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch, ct = cs.torch, cs.ct
    assert Path(ct.__file__).resolve().is_relative_to(root), ct.__file__
    ct.set_config(backend="scan")
    cs._build.build()
    dev = torch.device("cuda", 0)
    res = {"root": str(root), "device": torch.cuda.get_device_name(0)}
    for J, model, theta0 in ((2, cs.sho, cs.THETA0), (4, cs.sho_mixture, cs.THETA4)):
        for dtype in (torch.float64, torch.float32):
            res[f"evals_per_s_J{J}_{str(dtype)[6:]}"] = cs.steps_per_s(
                dev, dtype, model=model, theta0=theta0)
        prof = cs.profile_eval(dev, model, theta0, J)
        if prof is not None:
            mine = {k: v for k, v in prof["by_name"].items()
                    if k in cs.KERNELS or k in cs.GENERAL}
            prof["by_name"] = mine
            prof["glue_ms"] = prof["busy_ms"] - sum(ms for _, ms in mine.values())
        res[f"profile_J{J}"] = prof
    data = cs.bench_data(1_000_000, dev, torch.float64, seed=11, span=10_000.0)
    torch.cuda.reset_peak_memory_stats()
    res["evals_per_s_J4_float64_N1e6"] = cs.steps_per_s(
        dev, torch.float64, n_steps=5, model=cs.sho_mixture, theta0=cs.THETA4,
        data=data)
    res["peak_GiB_N1e6"] = torch.cuda.max_memory_allocated() / 2**30
    del data
    res["frev"] = cs.frev_times(dev)
    return res


def main(argv=None, script=Path(__file__).resolve(), turn=turn, out=OUT):
    """Run ``script`` (this file, or another with its own ``turn`` and
    ``out``) as one worker process per turn, other, this, this, other;
    ``argv`` holds the other checkout's root."""
    name = script.stem
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", help="root of the other checkout")
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        print(json.dumps(turn(Path(args.worker).resolve())))
        return 0
    import torch

    if not torch.cuda.is_available():
        print(f"{name}: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    out.parent.mkdir(exist_ok=True)
    other = Path(args.other).resolve()
    for k, root in enumerate((other, HERE, HERE, other)):
        start = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(script), str(other), "--worker", str(root)],
            capture_output=True, text=True, timeout=1500)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], flush=True)
            return proc.returncode
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res.update(turn=k, card=smi, seconds=time.perf_counter() - start)
        with out.open("a") as f:
            f.write(json.dumps(res) + "\n")
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
