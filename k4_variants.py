"""Times variants of K4 (``frev_maps_kernel``, csrc/fused_loglik.cu) against
the kernel itself on one NVIDIA GPU, in turns: the design choices behind
K4, each undone or changed by an edit of the source.

* ``walk_only``: the composition of the group's maps skipped (the walk,
  the maps into shared memory and the stores remain): K4's time without
  its composition;
* ``full_warp``: each composing warp carries kCols columns on its lanes
  below D, where the kernel gives each half-warp kCols columns of its own;
* ``cols4``, ``cols8``: 4 or 8 columns a half-warp instead of 2;
* ``split``: each of the composition's sums taken in two halves (even and
  odd columns of the map), two chains of dependent multiply-adds where
  the kernel runs one;
* ``skip_constants``: warps other than the affine one do not load the
  rows' bv0 and bdp, which only the affine step uses;
* ``unroll1``: the walk's row loop not unrolled (the kernel unrolls it
  twice).

It also counts, from ``cuobjdump -sass`` of the package's library, the
instructions of each loop of K4 at J = 4 in float64 (the walk's row loop is
the one with DMULs).

Each variant is built beside the package (``celerite2_torch/_build/``,
which git ignores) with the package's nvcc flags, called through its C
interface on the same inputs in the same blocks as the package's
``frev_maps_cuda``, and timed with CUDA events (50 calls, no wrapper) in
two rounds in opposite orders; its largest relative difference from the
kernel's outputs is reported beside.  Run from the root of the repository:

    python3 k4_variants.py

Writes one JSON object per shape and type to ``chiprun_out/k4_variants.jsonl``
and prints each.
"""

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from celerite2_torch.ops import _build

HERE = Path(__file__).resolve().parent
OUT = HERE / "chiprun_out" / "k4_variants.jsonl"
SHAPES = ((3, 100_000, 1), (4, 100_000, 1), (4, 100_000, 64),
          (4, 1_000_000, 1))

ROW = """      frev_row_tile<T, J>(tile + l * I::WIDTH * kPitch,
                          n0 + s * kTile + l == 0, pr, u, w, g, bd);
      structured_apply<T, J>(X, pr, u, w, g, bd, affine);"""
ROW_SKIP = """      {
        const T* xr = tile + l * I::WIDTH * kPitch;
        const bool r0 = n0 + s * kTile + l == 0;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          pr[j] = xr[(I::P + j) * kPitch];
          u[j] = r0 ? T(0) : xr[(I::U + j) * kPitch];
          w[j] = xr[(I::W + j) * kPitch];
          g[j] = affine ? xr[(I::G + j) * kPitch] : T(0);
        }
        bd = affine ? xr[I::BD * kPitch] : T(0);
      }
      structured_apply<T, J>(X, pr, u, w, g, bd, affine);"""
LOOP = ("#pragma unroll 2\n"
        "    for (int l = min(kTile, mine - s * kTile) - 1; l >= 0; --l) {\n"
        "      T pr[J], u[J], w[J], g[J], bd;\n" + ROW)
COMPOSE = "for (int b = nb - 2, buf = 1; b >= 0; --b, buf ^= 1) {"
START = ("    for (int c = 0; c < kCols; ++c) x[c] = kh + c == D ? "
         "m[D * D + row] : T(0);")
KCOLS = "constexpr int kCols = 2;"
VARIANTS = {
    "walk_only": [(COMPOSE, COMPOSE.replace("b >= 0", "b >= nb"))],
    "full_warp": [
        ("const int half = lane / (kWalks / 2);", "const int half = 0;"),
        ("const int row = min(lane % (kWalks / 2), D - 1);",
         "const int row = min(lane, D - 1);"),
        ("const bool live = lane % (kWalks / 2) < D;",
         "const bool live = lane < D;"),
        ("WARPS = (D + 2 * kCols) / (2 * kCols);", "WARPS = (D + kCols) / kCols;"),
        ("col * 4 * F::HS, col * 2 * kCols, nb);", "col * 4 * F::HS, col * kCols, nb);"),
    ],
    "cols4": [(KCOLS, "constexpr int kCols = 4;")],
    "cols8": [(KCOLS, "constexpr int kCols = 8;")],
    "split": [
        (START, "    T odd[kCols] = {};\n" + START),
        ("if (j + 1 < D) x[c] += a1 * v.y;", "if (j + 1 < D) odd[c] += a1 * v.y;"),
        ("    put(b, buf);\n",
         "    for (int c = 0; c < kCols; ++c) x[c] += odd[c];\n    put(b, buf);\n"),
    ],
    "skip_constants": [(ROW, ROW_SKIP)],
    "unroll1": [(LOOP, LOOP.replace("#pragma unroll 2", "#pragma unroll 1"))],
}


def build_variants():
    """Each variant's library, built by one nvcc each, all started
    together; returns {name: (ctypes library, registers of K4 at J = 3, 4
    by type)}."""
    src = (_build.CSRC / "fused_loglik.cu").read_text()
    root = _build.BUILD_DIR / "variants"
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the edit's text is not in the source once: {old!r}")
            text = text.replace(old, new)
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "fused_loglik.cu").write_text(text)
        shutil.copy(_build.CSRC / "device_common.cuh", d)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             str(d / "lib.so"), str(d / "fused_loglik.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{log[-4000:]}")
        regs = re.findall(r"frev_maps_kernelI([fd])Li([34])E[^\n]*\n[^\n]*\n"
                          r"[^\n]*\n[^\n]*Used (\d+) registers", log)
        lib = ctypes.CDLL(str(root / name / "lib.so"))
        lib.c2t_frev_maps.argtypes = [I, I] + [P] * 7 + [I, I, I, P]
        libs[name] = (lib, {f"{t}{j}": int(r) for t, j, r in regs})
    return libs


def sass_loops():
    """The loops of ``frev_maps_kernel<double, 4>`` in the package's
    library (each backward branch and the instructions from its target to
    it): their length and their float64 and shared-memory instructions."""
    lib = _build.build()
    cuobjdump = str(Path(_build._nvcc()).with_name("cuobjdump"))
    syms = subprocess.run([cuobjdump, "-symbols", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    fn = re.search(r"\S*frev_maps_kernelIdLi4E\S*", syms)[0]
    sass = subprocess.run([cuobjdump, "-sass", "-fun", fn, str(lib)],
                          capture_output=True, text=True, check=True).stdout
    code = [(int(m[1], 16), m[2]) for m in
            re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", sass)]
    loops = []
    for at, ins in code:
        back = re.search(r"\bBRA (?:\S+, )?0x([0-9a-f]+)", ins)
        if back and int(back[1], 16) < at:
            body = [i for a, i in code if int(back[1], 16) <= a <= at]
            ops = {op: sum(bool(re.search(rf"\b{op}\b", i)) for i in body)
                   for op in ("DFMA", "DMUL", "DADD", "LDS", "STS", "SHFL")}
            loops.append({"from": back[1], "to": f"{at:x}",
                          "instructions": len(body), **ops})
    return loops


def main():
    if not torch.cuda.is_available():
        print("k4_variants: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps({"sass_loops_frev_maps_double_J4": sass_loops()}), flush=True)
    libs = {"kernel": (_build._library(), {}), **build_variants()}
    print(json.dumps({k: regs for k, (_, regs) in libs.items() if regs}), flush=True)
    dev = torch.device("cuda", 0)
    OUT.parent.mkdir(exist_ok=True)
    for J, N, C in SHAPES:
        base = cs.frev_inputs(J, N, C, dev)
        for dtype in (torch.float64, torch.float32):
            fin = [x.to(dtype) for x in base]
            L = _build.structured_block_len(N, C)
            ref = _build.frev_maps_cuda(*fin)
            ms, err = {}, {}
            for order in (list(libs), list(reversed(list(libs)))):
                for name in order:
                    lib = libs[name][0]
                    outs = [torch.empty_like(x) for x in ref]

                    def call():
                        rc = lib.c2t_frev_maps(
                            int(dtype == torch.float64), J,
                            *(x.data_ptr() for x in (*fin, *outs)), C, N, L,
                            torch.cuda.current_stream().cuda_stream)
                        if rc:
                            raise RuntimeError(f"{name}: launch failed ({rc})")

                    ms.setdefault(name, []).append(cs.cuda_ms(call, 50))
                    err[name] = max(cs.scaled_err(o, r) for o, r in zip(outs, ref))
            row = {"J": J, "N": N, "C": C, "dtype": str(dtype)[6:], "rows": L,
                   "card": smi, "ms": ms, "err": err}
            with OUT.open("a") as f:
                f.write(json.dumps(row) + "\n")
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
