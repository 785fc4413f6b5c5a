"""Matrix-free exact GP regression at large n (round-4 capability).

``GPRegression(solver="iterative")`` past n=32768 never materializes the
(n, n) Gram: CG/SLQ matvecs rebuild (chunk, n) kernel slabs on the fly
(`models/gp_regression.py: make_gram_matvec`), the pivoted-Cholesky
preconditioner is built from r single kernel rows, and both the NLML and
prediction run as host loops of bounded device programs (dense storage at
n=500k would be 1 TB).

Run: ``python examples/demo_exact_matrixfree.py [--n 100000] [--gpu]``
(CPU default sizes are small; the matrix-free path is compute-bound at
O(n²) per matvec — exact GPs at this scale are for when the structured
models' assumptions genuinely do not fit).
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--gpu", action="store_true", help="run on the GPU (fails without one)")
    args = ap.parse_args()

    from gp_grief_jax.utils.backend import select_backend

    select_backend(args.gpu, x64_on_cpu=False)
    n = args.n or (100_000 if args.gpu else 5_000)

    import gp_grief_jax as gpx

    rng = np.random.default_rng(0)
    dtype = np.float32
    x = rng.uniform(0, 3, size=(n, 2)).astype(dtype)
    f = np.sin(2 * x[:, 0]) * np.cos(x[:, 1])
    y = (f + 0.05 * rng.standard_normal(n)).astype(dtype)

    model = gpx.GPRegression(
        x, y, gpx.make_kernel("rbf", lengthscale=0.8), noise_var=0.05,
        solver="iterative", num_probes=8, lanczos_iters=24,
        cg_tol=1e-5, cg_iters=100, precond_rank=128,
        matvec_chunk=max(128, (1 << 28) // n),
    )
    t0 = time.perf_counter()
    ll = model.log_likelihood_iterative_segmented(
        cg_segment_iters=8, probe_chunk=2, slq_iter_segment=6,
    )
    print(f"matrix-free NLML @ n={n}: {ll:.1f}  ({time.perf_counter() - t0:.1f}s; "
          "every device program bounded)")

    xs = rng.uniform(0.3, 2.7, size=(200, 2)).astype(dtype)
    t0 = time.perf_counter()
    mean = model.predict(xs, compute_var=False, chunk=64)
    rmse = float(np.sqrt(np.mean((mean - np.sin(2 * xs[:, 0]) * np.cos(xs[:, 1])) ** 2)))
    print(f"predict 200 pts: rmse vs truth {rmse:.4f}  ({time.perf_counter() - t0:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
