"""Example datasets as Pathway tables (reference:
python/pathway/stdlib/ml/datasets/classification/__init__.py
load_mnist_sample — fetch_openml MNIST split into train/test tables).

Zero-egress environments fall back to scikit-learn's bundled digits
dataset (8x8 images, shipped with sklearn, no network) with the same
return shape: (X_train, y_train, X_test, y_test) tables holding `data`
(np.ndarray) and `label` columns."""

from __future__ import annotations

import numpy as np


def _tables_from_arrays(X_train, y_train, X_test, y_test):
    import pandas as pd

    from pathway_tpu_torch.debug import table_from_pandas

    X_train_table = table_from_pandas(
        pd.DataFrame({"data": [np.asarray(x) for x in X_train]})
    )
    y_train_table = table_from_pandas(
        pd.DataFrame({"label": [str(y) for y in y_train]})
    )
    X_test_table = table_from_pandas(
        pd.DataFrame({"data": [np.asarray(x) for x in X_test]})
    )
    y_test_table = table_from_pandas(
        pd.DataFrame({"label": [str(y) for y in y_test]})
    )
    return X_train_table, y_train_table, X_test_table, y_test_table


def load_mnist_sample(sample_size: int = 70000):
    """reference: datasets/classification load_mnist_sample. Requires
    network for the real MNIST via openml; offline it raises."""
    from sklearn.datasets import fetch_openml

    X, y = fetch_openml(
        "mnist_784", version=1, return_X_y=True, as_frame=False
    )
    X = X / 255.0
    train_size = int(sample_size * 6 / 7)
    test_size = int(sample_size / 7)
    return _tables_from_arrays(
        X[:60000][:train_size],
        y[:60000][:train_size],
        X[60000:70000][:test_size],
        y[60000:70000][:test_size],
    )


def load_digits_sample(sample_size: int = 1797, train_fraction: float = 6 / 7):
    """Offline-friendly variant over sklearn's bundled 8x8 digits."""
    from sklearn.datasets import load_digits

    X, y = load_digits(return_X_y=True)
    X = X / 16.0
    X, y = X[:sample_size], y[:sample_size]
    split = int(len(X) * train_fraction)
    return _tables_from_arrays(X[:split], y[:split], X[split:], y[split:])
