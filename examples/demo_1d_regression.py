"""1D regression demo — the reference's flagship notebook as a script.

Fits both the exact GP and GP-GRIEF on noisy sine data, optimizes
hyperparameters with jax.grad NLML, and prints train/test metrics side by side
(reference: upstream 1D regression notebook — SURVEY.md §2 #20).

Run: ``python examples/demo_1d_regression.py [--gpu]``
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gpu", action="store_true", help="run on the GPU in f32 (fails without one)")
    ap.add_argument("--n", type=int, default=1000)
    args = ap.parse_args()

    import jax

    from gp_grief_jax.utils.backend import select_backend

    select_backend(args.gpu)

    import gp_grief_jax as gpx

    rng = np.random.default_rng(0)
    dtype = np.float32 if args.gpu else np.float64
    x = rng.uniform(0, 4, size=(args.n, 1)).astype(dtype)
    y = (np.sin(2 * x[:, 0]) + 0.1 * rng.standard_normal(args.n)).astype(dtype)
    xs = np.linspace(0, 4, 400)[:, None].astype(dtype)
    f_true = np.sin(2 * xs[:, 0])

    # --- GP-GRIEF: 100-point grid, p=10 eigenfunctions -----------------------
    grid = gpx.InducingGrid.build(x, mbar=100)
    grief = gpx.GPGriefModel(
        x, y, [gpx.make_kernel("rbf", lengthscale=0.5)], grid,
        n_eigs=10, noise_var=0.5, dtype=dtype,
    )
    res = grief.optimize(max_iters=100, optimizer="adam" if args.gpu else "lbfgs")
    gm, gv = grief.predict(xs)
    g_rmse = float(np.sqrt(np.mean((gm - f_true) ** 2)))
    print(f"GP-GRIEF : ll={grief.log_likelihood():10.2f}  rmse={g_rmse:.4f}  "
          f"({res.iterations} iters, {res.wall_time:.1f}s)")

    # --- exact GP oracle ------------------------------------------------------
    sub = slice(0, min(args.n, 1000))
    exact = gpx.GPRegression(x[sub], y[sub], gpx.make_kernel("rbf", lengthscale=0.5), noise_var=0.5)
    res = exact.optimize(max_iters=50, optimizer="adam" if args.gpu else "lbfgs")
    em, ev = exact.predict(xs)
    e_rmse = float(np.sqrt(np.mean((em - f_true) ** 2)))
    print(f"exact GP : ll={exact.log_likelihood():10.2f}  rmse={e_rmse:.4f}  "
          f"({res.iterations} iters, {res.wall_time:.1f}s)")
    print(f"mean abs predictive-mean gap GRIEF vs exact: {np.abs(gm - em).mean():.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
