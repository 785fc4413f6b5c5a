"""GRIEF demo at scale: d-dimensional grids with astronomically many virtual
inducing points (reference: upstream GRIEF/UCI notebook — SURVEY.md §2 #20;
the 10^100-virtual-point capability of BASELINE config 5).

Run: ``python examples/demo_grief_highdim.py [--d 100] [--n 2000] [--gpu]``
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, default=100)
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--p", type=int, default=200)
    ap.add_argument("--ard-iters", type=int, default=25,
                    help="opt_kernel_params Adam steps (each rebuilds+"
                         "differentiates the full basis; ~33 s/step at d=100)")
    ap.add_argument("--gpu", action="store_true", help="run on the GPU in f32 (fails without one)")
    args = ap.parse_args()

    import jax

    from gp_grief_jax.utils.backend import select_backend

    select_backend(args.gpu)

    import jax.numpy as jnp

    import gp_grief_jax as gpx

    rng = np.random.default_rng(0)
    dtype = np.float32 if args.gpu else np.float64
    x = rng.uniform(0, 1, size=(args.n, args.d)).astype(dtype)
    # Sparse additive ground truth: only a few dims matter.
    y = (np.sin(4 * x[:, 0]) + 0.7 * np.cos(3 * x[:, 1]) + 0.3 * x[:, 2]
         + 0.05 * rng.standard_normal(args.n)).astype(dtype)

    grid = gpx.InducingGrid.build(x, mbar=10)
    print(f"grid: {args.d} dims × {grid.grid_shape[0]} pts = 10^{grid.log10_num_virtual:.0f} "
          "virtual inducing points")

    # Per-dimension kernels + opt_kernel_params: ARD-style relevance — the
    # lengthscales of the ~97 irrelevant dims grow, flattening their factors.
    kerns = [gpx.make_kernel("rbf", lengthscale=1.5) for _ in range(args.d)]
    model = gpx.GPGriefModel(
        x, y, kerns, grid, n_eigs=args.p, noise_var=0.1, dtype=dtype,
        opt_kernel_params=True, dim_noise_var=1e-8,
    )
    print(f"initial ll: {model.log_likelihood():.2f}")
    # Two-phase recipe (the kin40k config's): a SHORT ARD phase — each
    # opt_kernel_params step differentiates the full d-dim basis rebuild
    # (~33 s/step at d=100 on one CPU core; 200 of them was an hours-long
    # demo) — then a cheap O(p³) reweighting polish at the learned hypers.
    res = model.optimize(
        optimizer="adam", max_iters=args.ard_iters, learning_rate=0.05
    )
    print(f"after ARD phase ll: {model.log_likelihood():.2f} "
          f"({res.iterations} iters, {res.wall_time:.1f}s)")
    model.opt_kernel_params = False
    model.refresh_basis()
    res = model.optimize(optimizer="adam", max_iters=150, learning_rate=0.05)
    print(f"after reweight polish ll: {model.log_likelihood():.2f} "
          f"({res.iterations} iters, {res.wall_time:.1f}s)")
    ls = sorted(
        (float(jnp.exp(k.log_lengthscale)), i) for i, k in enumerate(model.params["kernels"])
    )
    print("most relevant dims (smallest lengthscales):", [i for _, i in ls[:5]])

    xs = rng.uniform(0, 1, size=(500, args.d)).astype(dtype)
    f_true = np.sin(4 * xs[:, 0]) + 0.7 * np.cos(3 * xs[:, 1]) + 0.3 * xs[:, 2]
    mean = model.predict(xs, compute_var=False)
    print(f"test RMSE vs truth: {np.sqrt(np.mean((mean - f_true) ** 2)):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
