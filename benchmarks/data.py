"""Real-dataset loaders that activate when files appear (zero-egress fallback).

The environment cannot fetch UCI/kin40k (no network — SURVEY.md provenance
notes), so the BASELINE configs run on synthetic stand-ins by default.  If the
real files are dropped into ``benchmarks/data/`` (or a directory named by
``$GP_GRIEF_DATA``), the configs pick them up automatically and report metrics
on the genuine task.  :func:`synthetic_kin40k` / :func:`synthetic_uci2m` are
the seeded stand-ins at the published shapes.

Supported layouts per dataset:

kin40k (the GP-GRIEF paper's headline task; n_train=10000/30000 variants):
  - ``kin40k.npz`` with arrays ``x_train, y_train, x_test, y_test``; or
  - the classic 4-file ASCII export: ``kin40k_train_data.asc``,
    ``kin40k_train_labels.asc``, ``kin40k_test_data.asc``,
    ``kin40k_test_labels.asc``.

Large UCI regression (for the 2M config, e.g. HouseElectric):
  - ``uci2m.npz`` with arrays ``x, y`` (n ≥ 1e6 rows).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "data_dir", "load_kin40k", "load_uci2m", "standardize",
    "synthetic_kin40k", "synthetic_uci2m",
]


def data_dir() -> str:
    return os.environ.get(
        "GP_GRIEF_DATA", os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
    )


def standardize(
    x_train: np.ndarray, y_train: np.ndarray, x_test: np.ndarray, y_test: np.ndarray
):
    """Per-feature zero-mean/unit-variance on x, zero-mean/unit-variance on y,
    statistics from the training split only (the paper's protocol)."""
    xm, xs = x_train.mean(0), x_train.std(0) + 1e-12
    ym, ys = y_train.mean(), y_train.std() + 1e-12
    return (
        (x_train - xm) / xs,
        (y_train - ym) / ys,
        (x_test - xm) / xs,
        (y_test - ym) / ys,
        float(ys),
    )


def _check_split(x_train, y_train, x_test, y_test, what: str):
    """Fail LOUDLY on malformed files at load time (a bad shape otherwise
    only surfaces deep inside a config run)."""
    if x_train.ndim != 2 or x_test.ndim != 2:
        raise ValueError(
            f"{what}: x splits must be 2-D (n, d); got "
            f"{x_train.shape} / {x_test.shape}"
        )
    if x_train.shape[1] != x_test.shape[1]:
        raise ValueError(
            f"{what}: train/test feature dims differ: "
            f"{x_train.shape[1]} vs {x_test.shape[1]}"
        )
    if y_train.shape != (x_train.shape[0],) or y_test.shape != (x_test.shape[0],):
        raise ValueError(
            f"{what}: labels must be 1-D matching their x rows; got "
            f"y_train {y_train.shape} for x_train {x_train.shape}, "
            f"y_test {y_test.shape} for x_test {x_test.shape}"
        )
    return x_train, y_train, x_test, y_test


def load_kin40k(
    root: Optional[str] = None, dtype=np.float32
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Return ``(x_train, y_train, x_test, y_test)`` or ``None`` if absent."""
    root = root or data_dir()
    npz = os.path.join(root, "kin40k.npz")
    if os.path.exists(npz):
        z = np.load(npz)
        missing = [k for k in ("x_train", "y_train", "x_test", "y_test") if k not in z]
        if missing:
            raise ValueError(f"kin40k.npz: missing arrays {missing}")
        xt, yt, xe, ye = (
            np.asarray(z[k], dtype=dtype)
            for k in ("x_train", "y_train", "x_test", "y_test")
        )
        return _check_split(xt, yt.reshape(-1), xe, ye.reshape(-1), "kin40k.npz")
    asc = [
        os.path.join(root, f"kin40k_{s}.asc")
        for s in ("train_data", "train_labels", "test_data", "test_labels")
    ]
    if all(os.path.exists(p) for p in asc):
        xt, yt, xe, ye = (np.loadtxt(p) for p in asc)
        return _check_split(
            np.asarray(xt, dtype=dtype),
            np.asarray(yt, dtype=dtype).reshape(-1),
            np.asarray(xe, dtype=dtype),
            np.asarray(ye, dtype=dtype).reshape(-1),
            "kin40k .asc files",
        )
    return None


def load_uci2m(
    root: Optional[str] = None, dtype=np.float32
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Return ``(x, y)`` (n ≥ 1e6) or ``None`` if absent."""
    root = root or data_dir()
    npz = os.path.join(root, "uci2m.npz")
    if os.path.exists(npz):
        z = np.load(npz)
        missing = [k for k in ("x", "y") if k not in z]
        if missing:
            raise ValueError(f"uci2m.npz: missing arrays {missing}")
        x = np.asarray(z["x"], dtype=dtype)
        y = np.asarray(z["y"], dtype=dtype).reshape(-1)
        if x.ndim != 2 or y.shape != (x.shape[0],):
            raise ValueError(
                f"uci2m.npz: need x (n, d) and matching y (n,); got "
                f"x {x.shape}, y {np.asarray(z['y']).shape}"
            )
        if x.shape[0] < 10:
            # Fail loudly at load time: a degenerate file would otherwise
            # surface as an opaque empty-train-split error mid-config.
            raise ValueError(
                f"uci2m.npz: only {x.shape[0]} rows — need at least 10 "
                "(intended for n >= 1e6 datasets)"
            )
        return x, y
    return None


def synthetic_kin40k(dtype=np.float32, n: int = 40000, n_train: int = 30000, seed: int = 0):
    """Seeded kin40k-shaped task (d=8, 30k/10k split): a highly nonlinear,
    low-noise robot-arm-like target.  Returns ``(xtr, ytr, xte, yte, fte)``
    with ``fte`` the noiseless test targets."""
    rng = np.random.default_rng(seed)
    d = 8
    x = rng.uniform(-1, 1, size=(n, d)).astype(dtype)
    f = (np.sin(3 * x[:, 0] * x[:, 1]) + x[:, 2] * np.cos(2 * x[:, 3])
         + np.sin(x[:, 4] + 2 * x[:, 5]) * x[:, 6] + 0.5 * x[:, 7] ** 2)
    y = (f + 0.05 * rng.standard_normal(n)).astype(dtype)
    return x[:n_train], y[:n_train], x[n_train:], y[n_train:], f[n_train:]


def synthetic_uci2m(dtype=np.float32, n: int = 2_000_000, seed: int = 0):
    """Seeded uci2m-shaped task (2M×10).  Returns ``(x, y, f)`` with ``f``
    the noiseless targets."""
    rng = np.random.default_rng(seed)
    d = 10
    x = rng.uniform(-1, 1, size=(n, d)).astype(dtype)
    f = (np.sin(2 * x[:, 0]) * np.cos(x[:, 1]) + 0.4 * x[:, 2] * x[:, 3]
         + np.tanh(x[:, 4] + x[:, 5]))
    y = (f + 0.1 * rng.standard_normal(n)).astype(dtype)
    return x, y, f
