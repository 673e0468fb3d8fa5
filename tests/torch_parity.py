"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py):
inputs made with numpy from a seed, handed to the JAX package and to the
port alike."""

from __future__ import annotations

import jax
import numpy as np
import torch


def normal(rng: np.random.Generator, *shape, scale: float = 1.0) -> np.ndarray:
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def numpy_tree(tree):
    """A JAX param tree as nested dicts of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, tree)


def jitter(tree, seed: int, scale: float = 0.05):
    """Seeded noise on EVERY leaf. Many JAX inits are exactly 0 or 1 (biases,
    ada_norm_w, film_b, RMSNorm γ), and such leaves would hide a layout bug
    in the converter or the port."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + normal(rng, *np.shape(a), scale=scale)).astype(np.float32),
        tree,
    )


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def assert_close(actual, expected, atol: float, rtol: float = 0.0) -> None:
    actual = actual.detach().numpy() if isinstance(actual, torch.Tensor) else np.asarray(actual)
    np.testing.assert_allclose(actual, np.asarray(expected), atol=atol, rtol=rtol)


def assert_codes_match(x, codebooks, codes, expected, tie_tol: float) -> np.ndarray:
    """RVQ codes against expected codes, tie-tolerantly: a row may differ
    only from a stage where the two candidates' distances to the residual
    (advanced along the expected codes) are within ``tie_tol``; after that
    its residuals part ways. Returns the mask of rows that agree
    everywhere."""
    x, codebooks = np.asarray(x, np.float64), np.asarray(codebooks, np.float64)
    codes, expected = np.asarray(codes), np.asarray(expected)
    assert codes.shape == expected.shape
    same = (codes == expected).all(axis=1)
    for row in np.flatnonzero(~same):
        stage = int(np.flatnonzero(codes[row] != expected[row])[0])
        residual = x[row] - sum(codebooks[q][expected[row, q]] for q in range(stage))
        d_got = np.sum((residual - codebooks[stage][codes[row, stage]]) ** 2)
        d_want = np.sum((residual - codebooks[stage][expected[row, stage]]) ** 2)
        assert abs(d_got - d_want) <= tie_tol, (row, stage, d_got, d_want)
    return same
