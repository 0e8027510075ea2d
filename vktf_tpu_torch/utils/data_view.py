"""Non-owning contiguous data views.

Reference: src/engine/data_view.cppm:31-81 — ``DataView<T>`` unifies a single
value, pointer+size, array, or range into one non-owning view with a
``size_bytes`` helper used for buffer packing. In the TPU build numpy arrays
*are* the views; this module supplies the unifying constructor and the typed
byte-size helper so packing code reads the same.
"""

from __future__ import annotations

from typing import Any

import numpy as np


def as_view(data: Any, dtype=None) -> np.ndarray:
    """View `data` as a 1-D numpy array without copying when possible.

    Accepts a scalar (-> shape (1,) view), a sequence, or an ndarray
    (flattened). Mirrors DataView's implicit constructors
    (data_view.cppm:37-55).
    """
    if data is None:
        # the reference's null-with-size death test (data_view_test.cpp:60-62)
        raise TypeError("as_view(None): a view must reference real data")
    if np.isscalar(data):
        return np.asarray([data], dtype=dtype)
    arr = np.asarray(data, dtype=dtype)
    if arr.dtype == object:
        raise TypeError(f"as_view: not a contiguous numeric view: {type(data)}")
    return arr.reshape(-1)


def size_bytes(data: Any, dtype=None) -> int:
    """Total byte size of the viewed data (data_view.cppm:66-71)."""
    return as_view(data, dtype=dtype).nbytes
