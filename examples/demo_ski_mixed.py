"""SKI / KISS-GP demo with mixed-precision CG.

Fits :class:`GPSKIRegression` (scattered data tied to an inducing lattice by
linear interpolation — reference capability class: structured-kernel
interpolation over the same `KronMatrix` grid algebra, SURVEY.md §2 #12) on a
2-D toy task, twice: with exact-precision CG and with
``cg_precision="mixed"`` (iterative-refined CG — the low-precision hot loop with
exact residual refreshes, ops/cg.py:cg_solve_refined), and prints NLML/RMSE
side by side.  On CPU both paths are identical (``lax.Precision`` only
affects accelerator dots); on the GPU the mixed path's inner loop runs
TF32 products while the exact refreshes set the accuracy.

Run: ``python examples/demo_ski_mixed.py [--gpu] [--n 20000]``
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gpu", action="store_true", help="run on the GPU in f32 (fails without one)")
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--mbar", type=int, default=40)
    args = ap.parse_args()

    import jax

    from gp_grief_jax.utils.backend import select_backend

    select_backend(args.gpu)

    import gp_grief_jax as gpx

    dtype = "float32" if args.gpu else "float64"
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 4, size=(args.n, 2)).astype(dtype)
    f = np.sin(2 * x[:, 0]) * np.cos(x[:, 1])
    y = (f + 0.1 * rng.standard_normal(args.n)).astype(dtype)

    for prec in ("exact", "mixed"):
        t0 = time.perf_counter()
        model = gpx.GPSKIRegression(
            x, y, [gpx.make_kernel("rbf", lengthscale=0.7) for _ in range(2)],
            mbar=args.mbar, noise_var=0.1, cg_precision=prec,
            num_probes=8, cg_tol=1e-6,
        )
        model.optimize(optimizer="adam", max_iters=30, learning_rate=0.05)
        mean = model.predict(x[:2000], compute_var=False)
        rmse = float(np.sqrt(np.mean((mean - f[:2000]) ** 2)))
        print(
            f"cg_precision={prec:5s}  NLML {model.log_likelihood():12.2f}  "
            f"train-RMSE {rmse:.4f}  wall {time.perf_counter() - t0:.1f}s"
        )


if __name__ == "__main__":
    main()
