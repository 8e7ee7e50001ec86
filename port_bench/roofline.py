"""Operations, bytes and the card's peaks, worked out from a configuration's shapes.

Nothing here reads the program: every count follows from the configuration
file (fields, embedding width, tower widths) and the cell's batch. The peaks
are NVIDIA's published figures for one H100 SXM (dense, without sparsity);
a card set below its 700 W limit runs under them.
"""

from __future__ import annotations

from typing import Dict

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12          # outside the tensor cores: TF32 is off
INT8_OPS = 1979e12
PEAKS = {"fp32": FP32_FLOPS, "int8": INT8_OPS}


def _dims(cfg: Dict):
    f, e, h, d = cfg["field_size"], cfg["embedding_size"], cfg["deep_nodes"], cfg["h_depth"]
    return f, e, h, d


def tower_macs(cfg: Dict) -> int:
    """Multiply-adds of the deep tower for one example: F*E -> H, (depth-1) x H -> H,
    and the 1-unit head."""
    f, e, h, d = _dims(cfg)
    return f * e * h + (d - 1) * h * h + h


def shallow_ops(cfg: Dict) -> int:
    """Operations of one example outside the tower: the FwFM contraction
    R_sym @ emb (2 F^2 E), its pair and diagonal sums (4 F E), the fwlw term
    (2 F E) and the lw head (2 F)."""
    f, e, _, _ = _dims(cfg)
    return 2 * f * f * e + 4 * f * e + 2 * f * e + 2 * f


def forward_ops(cfg: Dict, batch: int, precision: str = "fp32") -> Dict[str, int]:
    """Model operations of one forward of ``batch`` rows, by the precision
    they run in: under ``int8-dynamic`` the tower's products are int8, the rest
    float32."""
    tower = 2 * tower_macs(cfg) * batch
    shallow = shallow_ops(cfg) * batch
    if precision == "int8-dynamic":
        return {"fp32": shallow, "int8": tower}
    return {"fp32": shallow + tower, "int8": 0}


def train_step_ops(cfg: Dict, batch: int) -> Dict[str, int]:
    """Model operations of one training step: the forward and a backward of
    twice its operations (a product's gradients with respect to both of its
    operands), all float32. The optimizer's elementwise passes are no model
    operations."""
    return {"fp32": 3 * forward_ops(cfg, batch)["fp32"], "int8": 0}


def least_seconds(ops: Dict[str, int]) -> float:
    """The time the card needs for ``ops`` at its peaks, each precision at its own."""
    return sum(n / PEAKS[p] for p, n in ops.items())


def int8_tower_bytes(cfg: Dict, batch: int) -> int:
    """Bytes the int8 tower must move at ``batch`` rows: its f32 input read
    once, the int8 weights, each hidden layer's f32 channel scales and biases,
    the head's f32 scale, and the f32 output written once."""
    f, e, h, d = _dims(cfg)
    return (batch * f * e * 4 + tower_macs(cfg) + d * 2 * h * 4 + 4 + batch * 4)


def int8_tower_least_seconds(cfg: Dict, batch: int) -> float:
    """The larger of the tower's bytes over HBM bandwidth and its int8
    operations over the int8 peak."""
    return max(int8_tower_bytes(cfg, batch) / HBM_BYTES_PER_S,
               2 * tower_macs(cfg) * batch / INT8_OPS)


def pruned_values(cfg: Dict) -> int:
    """Values one prune refresh thresholds: the second-order table (F-group),
    the tower's hidden weights and the fwlw weights (D-group), and the field
    matrix R when ``prune_r`` is on. Biases, the heads and lw are not pruned."""
    f, e, h, d = _dims(cfg)
    n = 0
    if cfg.get("prune_fm", True):
        n += sum(cfg["feature_sizes"]) * e
    if cfg.get("prune_deep", True):
        n += f * e * h + (d - 1) * h * h + f * e
    if cfg.get("prune_r", False):
        n += f * f
    return n


def refresh_bytes(cfg: Dict) -> int:
    """Each pruned float32 value read once and written once."""
    return 2 * 4 * pruned_values(cfg)


def refresh_least_seconds(cfg: Dict) -> float:
    return refresh_bytes(cfg) / HBM_BYTES_PER_S


def param_count(cfg: Dict) -> int:
    """Parameters of DeepFwFM with lw and fwlw: the second-order table, the
    tower with its biases and head, fwlw, R, lw and the bias."""
    f, e, h, d = _dims(cfg)
    return (sum(cfg["feature_sizes"]) * e + tower_macs(cfg) + d * h + f * e + f * f + f + 1)
