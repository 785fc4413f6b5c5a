"""On-grid exact GP (Kronecker algebra) demo — GPKroneckerRegression.

Covers the reference's grid-structured exact-GP capability (SURVEY.md §2
#1/#6-#8; BASELINE config 2) plus the extensions that have no
reference counterpart:

1. exact NLML + training on a full Cartesian lattice via per-dim eigh
   (never O(m³));
2. scattered-point prediction off the grid (Khatri-Rao cross-covariances);
3. grouped grid dimensions (``sub_dim``: one grid axis spanning several
   input columns);
4. model parallelism: ``mesh=`` shards every CG matvec's lattice over
   devices (run with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``
   on CPU to see it without several GPUs).

Run: ``python examples/demo_kron_grid.py``
"""

import numpy as np

import jax

import gp_grief_jax as gpx
from gp_grief_jax.models.gp_kron import GPKroneckerRegression


def main():
    rng = np.random.default_rng(0)

    # -- 1. exact GP on a 40x40x40 lattice (64k points) ---------------------
    xg = [np.linspace(0, 1, 40)[:, None] for _ in range(3)]
    g0, g1, g2 = np.meshgrid(*[g[:, 0] for g in xg], indexing="ij")
    f = np.sin(4 * g0) * np.cos(3 * g1) + 0.5 * g2
    y = (f + 0.05 * rng.standard_normal(f.shape)).reshape(-1)

    model = GPKroneckerRegression(
        xg, y, [gpx.make_kernel("matern52", lengthscale=0.3) for _ in range(3)],
        noise_var=0.1,
    )
    print("lattice m =", model.m, " NLML =", float(model.log_likelihood()))
    model.optimize(optimizer="adam", max_iters=60, learning_rate=0.1)
    print("after training NLML =", float(model.log_likelihood()))

    # -- 2. scattered-point prediction off the grid -------------------------
    xs = rng.uniform(0.05, 0.95, size=(500, 3))
    fs = np.sin(4 * xs[:, 0]) * np.cos(3 * xs[:, 1]) + 0.5 * xs[:, 2]
    mean, var = model.predict(xs)
    rmse = float(np.sqrt(np.mean((mean - fs) ** 2)))
    print(f"off-grid predict rmse = {rmse:.4f}  (noise floor 0.05), "
          f"var in [{var.min():.2e}, {var.max():.2e}]")

    # -- 3. grouped dims: one 2-column spatial grid axis --------------------
    xg2 = [np.linspace(0, 1, 12)[:, None], rng.uniform(0, 1, size=(30, 2))]
    m2 = 12 * 30
    y2 = rng.standard_normal(m2)
    grouped = GPKroneckerRegression(
        xg2, y2,
        [gpx.make_kernel("rbf", lengthscale=0.4),
         gpx.make_kernel("rbf", lengthscale=0.5, input_dim=2)],
        noise_var=0.3,
    )
    print("grouped dims:", grouped.dims,
          " NLML =", float(grouped.log_likelihood()))
    mg, vg = grouped.predict(rng.uniform(0, 1, size=(5, 3)))
    print("grouped predict mean[:3] =", np.round(mg[:3], 3))

    # -- 4. model parallelism (needs >= 2 devices) --------------------------
    if len(jax.devices()) >= 2:
        from gp_grief_jax.parallel import make_mesh

        k = 2 if len(jax.devices()) % 2 == 0 else 1
        if k > 1:
            mesh = make_mesh((len(jax.devices()) // k, k), ("data", "model"))
            par = GPKroneckerRegression(
                xg, y,
                [gpx.make_kernel("matern52", lengthscale=0.3) for _ in range(3)],
                noise_var=0.1, solver="cg", mesh=mesh,
            )
            print("model-parallel CG NLML =", float(par.log_likelihood()),
                  " (mesh:", dict(zip(mesh.axis_names, mesh.devices.shape)), ")")
    else:
        print("single device — skipping the model-parallel section")


if __name__ == "__main__":
    main()
