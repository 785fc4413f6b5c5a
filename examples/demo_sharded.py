"""Data-parallel GP-GRIEF training over a device mesh.

Runs on any device count: the host's GPUs (``--gpu``), or (default here) 8
virtual CPU devices for local experimentation.  The sharded model's NLML
computes local Φ blocks per device and psum-reduces the p×p statistics —
same API as the single-device ``GPGriefModel``.

Run: ``python examples/demo_sharded.py [--gpu]``
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# For local demonstration: 8 virtual CPU devices (set before jax init).
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--gpu", action="store_true", help="run on the GPUs (fails without one)")
    args = ap.parse_args()

    import jax

    from gp_grief_jax.utils.backend import select_backend

    # Without --gpu: the 8-virtual-device CPU mesh (the env flag above was
    # set before import; the platform is pinned before any backend use).
    select_backend(args.gpu, x64_on_cpu=False)

    import gp_grief_jax as gpx
    from gp_grief_jax.parallel import ShardedGPGriefModel

    print("devices:", jax.devices())
    rng = np.random.default_rng(0)
    n, d = 4000, 3
    x = rng.uniform(0, 1, size=(n, d)).astype(np.float32)
    y = (np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.5 * x[:, 2]
         + 0.05 * rng.standard_normal(n)).astype(np.float32)

    model = ShardedGPGriefModel(
        x, y, [gpx.make_kernel("rbf", lengthscale=0.4) for _ in range(d)],
        n_eigs=64, mbar=12, noise_var=0.2, dtype=np.float32,
    )
    print(f"initial ll: {model.log_likelihood():.2f}")
    res = model.optimize(optimizer="adam", max_iters=100, learning_rate=0.05)
    print(f"optimized ll: {model.log_likelihood():.2f} ({res.iterations} iters, {res.wall_time:.1f}s)")

    xs = rng.uniform(0.1, 0.9, size=(400, d)).astype(np.float32)
    truth = np.sin(4 * xs[:, 0]) * np.cos(3 * xs[:, 1]) + 0.5 * xs[:, 2]
    mean = model.predict(xs, compute_var=False)
    print(f"test RMSE: {np.sqrt(np.mean((mean - truth) ** 2)):.4f}")

    # Data-parallel SKI: per-shard interpolation plans, psum-coupled CG/SLQ.
    from gp_grief_jax.parallel import ShardedGPSKIRegression

    ski = ShardedGPSKIRegression(
        x[:, :2], y, gpx.make_kernel("rbf", lengthscale=0.4), mbar=10,
        noise_var=0.2, num_probes=16, lanczos_iters=30, cg_iters=300,
        cg_tol=1e-8, precond_rank=64,
    )
    print(f"sharded SKI ll: {ski.log_likelihood():.2f}")
    mean_s, var_s = ski.predict(xs[:, :2][:100])
    print(f"sharded SKI predict: mean[0]={mean_s[0]:.3f} var range "
          f"[{var_s.min():.3e}, {var_s.max():.3e}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
