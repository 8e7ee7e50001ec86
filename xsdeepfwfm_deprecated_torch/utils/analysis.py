"""Analysis utilities: sparse↔dense DNN matching + R-matrix heatmap. The port's
own copy of ``xsdeepfwfm_deprecated_tpu/utils/analysis.py``; ``matplotlib``
and ``pandas`` are optional and imported only where used.

Counterparts of the reference's analysis scripts
(``utils/find_the_similar_sparse_dnn.py`` and ``utils/plot_criteo_R_matrix.py``),
used for the paper's Table 5 comparisons and Figure 2 heatmap.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def dnn_param_count(input_dim: int, nodes: int, depth: int) -> int:
    """Dense tower parameter count: input→nodes→…→nodes→1 with biases on
    hidden layers, bias-free head (matching the framework's deep tower)."""
    total = input_dim * nodes + nodes
    for _ in range(depth - 1):
        total += nodes * nodes + nodes
    total += nodes
    return total


def find_similar_dense_dnn(sparse_rate: float, *, input_dim: int = 390,
                           nodes: int = 400, depth: int = 3,
                           candidates: Sequence[int] = tuple(range(4, 400, 4))
                           ) -> Tuple[int, int, int]:
    """Find the dense tower width whose parameter count best matches a sparse
    400-wide tower at the given sparsity (reference
    ``utils/find_the_similar_sparse_dnn.py:3-27``; paper Table 5's "N-X"
    baselines). Returns (best_width, sparse_params, dense_params)."""
    sparse_params = int(dnn_param_count(input_dim, nodes, depth) * (1.0 - sparse_rate))
    best, best_count, best_gap = candidates[0], 0, float("inf")
    for w in candidates:
        count = dnn_param_count(input_dim, w, depth)
        gap = abs(count - sparse_params)
        if gap < best_gap:
            best, best_count, best_gap = w, count, gap
    return best, sparse_params, best_count


def plot_r_matrix(r: np.ndarray, out_path: Optional[str] = None,
                  field_names: Optional[Sequence[str]] = None):
    """Heatmap of the (symmetrized) trained field matrix R (reference
    ``utils/plot_criteo_R_matrix.py:7-19``). Saves to ``out_path`` if given;
    returns the matplotlib figure (or the symmetrized array if matplotlib is
    unavailable)."""
    r = np.asarray(r, dtype=np.float64)
    sym = 0.5 * (r + r.T)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:          # headless/minimal env: return the data
        return sym
    fig, ax = plt.subplots(figsize=(8, 7))
    im = ax.imshow(sym, cmap="coolwarm")
    fig.colorbar(im, ax=ax)
    ax.set_title("FwFM field matrix R (symmetrized)")
    if field_names is not None:
        ax.set_xticks(range(len(field_names)))
        ax.set_xticklabels(field_names, rotation=90, fontsize=6)
        ax.set_yticks(range(len(field_names)))
        ax.set_yticklabels(field_names, fontsize=6)
    if out_path:
        fig.savefig(out_path, dpi=150, bbox_inches="tight")
    return fig


def save_memory(df):
    """Dtype downcaster for pandas frames (reference ``utils/util.py:76-97``)."""
    import numpy as np
    for col in df.columns:
        dt = df[col].dtype
        if dt in ("uint8", "bool"):
            df[col] = df[col].astype(np.int8)
        elif dt == "uint32":
            df[col] = df[col].astype(np.int32)
        elif dt == "int64":
            df[col] = df[col].astype(np.int32)
        elif dt == "float64":
            df[col] = df[col].astype(np.float32)
    return df
