"""Times the assoc tier's prefix kernels of this checkout against another
checkout of the repository on one NVIDIA GPU, in turns.

Each checkout runs in its own process, in the order other, this, this,
other; the other is usually the parent commit, unpacked with ``git
archive`` into a directory git ignores (``_checkout/``).  A turn imports
that checkout's ``celerite2_torch`` and times its
``_build.riccati_prefix_cuda`` and ``_build.kalman_prefix_cuda`` (K = 1,
and K = 5 at J = 16, 32) with CUDA events, at the block length each
checkout chooses, on this checkout's ``chip_smoke.prefix_inputs`` (float64):
J = 2, 4, 8 at N = 1e5 with C = 1 and 64 chains, and J = 16, 32 at
``chip_smoke.py``'s own shape for them, N = 1e4 with C = 8.  It also times
``_build.mat_affine_prefix_cuda`` on the lower solve's elements
(``chip_smoke.solve_maps``, K = 1) at J = 4 and 8, N = 1e5, C = 1 and 64,
and on phase B's shape (98 maps of 64 x 64, one chain), and
``_build.affine_prefix_cuda`` on the rectangular product's (phi, G) at
J = 8, K = 1, N = 1e5, C = 1 and 64.  Under ``torch.profiler`` (device
only, 10 calls) it reads the device time of each kernel that the
matrix-affine prefix at J = 4, N = 1e5, C = 1 launches, and, where the
checkout has them (``mat_affine_total_cuda``), of the total map and of the
prefix from ``x0`` on contracting D = 25 maps at one rank's B = 2.5e5 rows
in reverse (``chip_smoke.carry_times``' shapes).

    python3 prefix_turns.py _checkout/parent

Writes one JSON object per turn to ``chiprun_out/prefix_turns.jsonl`` and
prints each (``fused_turns.main`` runs the turns).
"""

import importlib.util
import os
import sys
from pathlib import Path

import fused_turns

HERE = Path(__file__).resolve().parent
OUT = HERE / "chiprun_out" / "prefix_turns.jsonl"
SHAPES = [(J, 100_000, C, (1,)) for C in (1, 64) for J in (2, 4, 8)]
SHAPES += [(J, 10_000, 8, (1, 5)) for J in (16, 32)]


def turn(root):
    """One turn: the times of ``root``'s prefix kernels, as a dict."""
    sys.path.insert(0, str(root))
    os.chdir(root)
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch, b = cs.torch, cs._build
    assert Path(cs.ct.__file__).resolve().is_relative_to(root), cs.ct.__file__
    b.build()
    dev = torch.device("cuda", 0)
    res = {"root": str(root), "device": torch.cuda.get_device_name(0)}
    for J, N, C, Ks in SHAPES:
        p, a, U, V, Y = cs.prefix_inputs(J, N, C, max(Ks), dev, seed=J)
        reps = 5 if C * J >= 64 or J >= 16 else 20
        key = f"J{J}_N{N}_C{C}"
        res[f"riccati_{key}"] = cs.cuda_ms(lambda: b.riccati_prefix_cuda(p, a, U, V),
                                           reps=reps)
        for K in Ks:
            Yk = Y[..., :K].contiguous()
            res[f"kalman_K{K}_{key}"] = cs.cuda_ms(
                lambda: b.kalman_prefix_cuda(p, a, U, V, Yk), reps=reps)
        del p, a, U, V, Y
        torch.cuda.empty_cache()
    for J in (4, 8):
        for C in (1, 64):
            A, bb = cs.solve_maps(J, 100_000, C, dev, seed=J)
            res[f"mat_affine_J{J}_N100000_C{C}"] = cs.cuda_ms(
                lambda: b.mat_affine_prefix_cuda(A, bb), reps=5 if C > 1 else 20)
            del A, bb
            torch.cuda.empty_cache()
    rng = cs.np.random.default_rng(5)
    A = torch.tensor(rng.normal(size=(1, 98, 64, 64)) / 12.0, device=dev)
    bb = torch.tensor(rng.normal(size=(1, 98, 64, 1)), device=dev)
    res["mat_affine_D64_M98_C1"] = cs.cuda_ms(lambda: b.mat_affine_prefix_cuda(A, bb),
                                              reps=20)
    A, bb = cs.solve_maps(4, 100_000, 1, dev, seed=4)
    res["parts_mat_affine_J4_N100000_C1"] = device_parts(
        cs, lambda: b.mat_affine_prefix_cuda(A, bb))
    del A, bb
    if hasattr(b, "mat_affine_total_cuda"):
        B, D = cs.SHARD_ROWS, 25
        A = torch.tensor(rng.normal(size=(1, B, D, D)) * 0.9 / 5.0, device=dev)
        bb = torch.tensor(rng.normal(size=(1, B, D, 1)), device=dev)
        x0 = torch.randn_like(bb[:, 0])
        res["parts_mat_affine_total_D25"] = device_parts(
            cs, lambda: b.mat_affine_total_cuda(A, bb, True))
        res["parts_mat_affine_x0_D25"] = device_parts(
            cs, lambda: b.mat_affine_prefix_cuda(A, bb, True, x0=x0))
        del A, bb
        torch.cuda.empty_cache()
    for C in (1, 64):
        t, c, _, _, V, Y = cs.wide_system(8, 100_000, C, 1, dev, seed=8)
        G = (V[..., None] * Y[..., None, :]).contiguous()
        phi = cs.scan.transport(t, c)
        res[f"affine_J8_K1_N100000_C{C}"] = cs.cuda_ms(
            lambda: b.affine_prefix_cuda(phi, G), reps=20)
    return res


def device_parts(cs, fn, n=10):
    """Device ms per call of each kernel that ``fn`` launches, by the
    kernel's function name (None where the trace holds no device time)."""
    prof = cs.profile_calls(fn, 4, n=n, host_ops=False)
    if prof is None:
        return None
    parts = {}
    for name, (_, ms) in prof["by_name"].items():
        key = cs.part_name(name)
        parts[key] = parts.get(key, 0.0) + ms
    return parts


def main(argv=None):
    return fused_turns.main(argv, Path(__file__).resolve(), turn, OUT)


if __name__ == "__main__":
    sys.exit(main())
