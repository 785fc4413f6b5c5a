"""CLI: ``python -m gp_grief_jax <subcommand>``.

Subcommands mirror the reference's debug utilities (SURVEY.md §5 "keep the
checkgrad-style parity table as a CLI subcommand"):

* ``checkgrad`` — fit a small GRIEF model and print the analytic-vs-FD table
  (``--sample K`` caps FD probes at ~K components; scalar hypers always run).
* ``bench``     — run the headline Kron-matvec bandwidth benchmark.
* ``configs``   — run BASELINE target configs (args forwarded).
"""

from __future__ import annotations

import sys


def _checkgrad(rest=()):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np

    import gp_grief_jax as gpx
    from gp_grief_jax.optimize import checkgrad

    rng = np.random.default_rng(0)
    x = rng.uniform(0, 4, size=(120, 2))
    y = np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.05 * rng.standard_normal(120)
    model = gpx.GPGriefModel(
        x, y, [gpx.make_kernel("rbf", lengthscale=0.5) for _ in range(2)],
        n_eigs=12, mbar=8, noise_var=0.1, opt_kernel_params=True,
    )
    sample = None
    rest = list(rest)
    if "--sample" in rest:
        i = rest.index("--sample")
        if i + 1 >= len(rest):
            print("usage: checkgrad [--sample K]  (K = max FD probes, int)")
            return 2
        try:
            sample = int(rest[i + 1])
        except ValueError:
            print(f"--sample expects an integer, got {rest[i + 1]!r}")
            return 2
    print("GPGriefModel (opt_kernel_params=True) checkgrad table:")
    ok, _ = checkgrad(model._loss, model.params, verbose=True, sample=sample)
    print("OK" if ok else "MISMATCH")
    return 0 if ok else 1


def main(argv):
    if len(argv) < 1 or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "checkgrad":
        return _checkgrad(rest)
    if cmd == "bench":
        sys.argv = ["bench"] + rest
        import pathlib

        root = pathlib.Path(__file__).resolve().parent.parent
        sys.path.insert(0, str(root))
        import bench

        bench.main()
        return 0
    if cmd == "configs":
        import pathlib

        root = pathlib.Path(__file__).resolve().parent.parent
        sys.path.insert(0, str(root / "benchmarks"))
        import run_configs

        for name in rest or ["sine1d", "grid3d", "d100"]:
            run_configs.ALL[name]()
        return 0
    print(f"unknown subcommand {cmd!r}\n{__doc__}")
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
