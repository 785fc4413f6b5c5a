"""Flagship scale demo: SKI / KISS-GP on ONE MILLION scattered points.

End-to-end workflow on one GPU (reference capability class:
structured-kernel interpolation over the KronMatrix grid algebra,
SURVEY.md §2 #12; the reference library is single-process NumPy — this
configuration is far past its practical reach):

1. build ``GPSKIRegression(solver="lattice", train_mixed16=True)`` on a
   d=4, 32^4 inducing lattice (M = 1,048,576 grid points, ~n);
2. train with segmented Adam steps — bf16 CG state + bf16 Kron-matvec
   inputs in the whitened lattice dual (loss within ~0.3% of f32 steps);
3. evaluate the TRUE NLML (f32 solves, segmented SLQ log-det);
4. predict mean + exact variances at held-out points (whitened-dual CG).

Variances are clamped at >= 0:
at ~1 point per grid cell the latent variance sits below f32
resolution, so the minimum prints as exactly 0.  Run smaller/CPU:
``python examples/demo_ski_1m.py --n 100000 --ms 16``.

Run: ``python examples/demo_ski_1m.py [--n 1000000] [--ms 32] [--steps 20]``
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def f_true(x):
    return (
        np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1])
        + 0.5 * x[:, 2] * x[:, 3]
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--ms", type=int, default=32, help="grid points per dim")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--n-test", type=int, default=2000)
    args = ap.parse_args()

    from gp_grief_jax.utils import enable_compilation_cache

    enable_compilation_cache()

    import gp_grief_jax as gpx

    d = 4
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, size=(args.n, d)).astype(np.float32)
    y = (f_true(x) + 0.05 * rng.standard_normal(args.n)).astype(np.float32)
    xg = [np.linspace(-0.05, 1.05, args.ms, dtype=np.float32)[:, None]] * d

    t0 = time.time()
    model = gpx.GPSKIRegression(
        x, y, [gpx.make_kernel("rbf", lengthscale=0.3) for _ in range(d)],
        xg, noise_var=0.05, solver="lattice", train_mixed16=True,
        num_probes=8, lanczos_iters=30, cg_iters=300, cg_tol=1e-6,
    )
    print(f"build: n={args.n:,}, lattice {args.ms}^{d} "
          f"(M={args.ms**d:,}) in {time.time() - t0:.1f} s", flush=True)

    t0 = time.time()
    res = model.optimize_segmented(
        max_iters=args.steps, learning_rate=0.05, num_probes=8, verbose=True
    )
    print(f"train: {args.steps} Adam steps in {time.time() - t0:.1f} s "
          f"(surrogate {res.losses[0]:.0f} -> {res.losses[-1]:.0f})",
          flush=True)

    t0 = time.time()
    ll = model.log_likelihood_segmented()
    print(f"true NLML: {-float(ll):.1f} in {time.time() - t0:.1f} s",
          flush=True)

    xs = rng.uniform(0.05, 0.95, size=(args.n_test, d)).astype(np.float32)
    t0 = time.time()
    mean, var = model.predict(xs)
    rmse = float(np.sqrt(np.mean((mean - f_true(xs)) ** 2)))
    cal = float(np.mean(np.abs(mean - f_true(xs)) <= 2 * np.sqrt(var + np.exp(
        float(model.params["log_noise"])))))
    print(f"predict: {args.n_test} points in {time.time() - t0:.1f} s — "
          f"rmse {rmse:.4f}, var range [{float(var.min()):.2e}, "
          f"{float(var.max()):.2e}], 2σ coverage {cal:.3f}", flush=True)
    assert rmse < 0.05 and var.min() >= 0 and var.max() > 0
    print("OK", flush=True)


if __name__ == "__main__":
    main()
