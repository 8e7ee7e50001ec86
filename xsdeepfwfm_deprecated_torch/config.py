"""Model configuration: the port's own copy of ``ModelConfig``.

Same fields, derived properties and ``__post_init__`` checks as
``xsdeepfwfm_deprecated_tpu/config.py:23-127``, so a config built for one
package builds the same model in the other. ``TrainConfig`` and the CLI
parser come with the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Static model architecture config.

    Exactly one of ``use_logit / use_fm / use_ffm / use_fwfm`` may be set;
    ``use_deep`` composes with any of them (DeepFM / DeepFFM / DeepFwFM) or
    stands alone.
    """

    field_size: int
    feature_sizes: Tuple[int, ...]
    numerical: int = 13  # the first `numerical` fields are scalar-valued
    embedding_size: int = 10

    use_logit: bool = False
    use_fm: bool = False
    use_ffm: bool = False
    use_fwfm: bool = True
    use_deep: bool = True
    use_lw: bool = False     # linear weights on the 1st-order term
    use_fwlw: bool = False   # FwFM linear weights from the 2nd-order embeddings

    h_depth: int = 3
    deep_nodes: int = 400
    num_deeps: int = 1

    dropout_shallow: Tuple[float, float] = (0.0, 0.0)
    dropout_deep: float = 0.5
    is_shallow_dropout: bool = True
    is_deep_dropout: bool = True

    qr_flag: bool = False
    qr_operation: str = "mult"   # mult | add | concat
    qr_collisions: int = 4
    qr_threshold: int = 200      # fields with feature_size > threshold use QR

    quantization_aware: bool = False
    static_quantization: bool = False
    dynamic_quantization: bool = False

    table_dtype: str = "f32"     # f32 | bf16 embedding-table storage

    n_class: int = 1

    def __post_init__(self):
        n_shallow = int(self.use_logit) + int(self.use_fm) + int(self.use_ffm) + int(self.use_fwfm)
        if n_shallow > 1:
            raise ValueError("only one of use_logit/use_fm/use_ffm/use_fwfm may be set")
        if n_shallow == 0 and not self.use_deep:
            raise ValueError("choose at least one of (logit, fm, ffm, fwfm, deep)")
        if len(self.feature_sizes) != self.field_size:
            raise ValueError(
                f"feature_sizes has {len(self.feature_sizes)} entries, expected {self.field_size}")
        if self.qr_flag and self.qr_operation not in ("mult", "add", "concat"):
            raise ValueError(f"invalid qr_operation {self.qr_operation!r}")
        if self.table_dtype not in ("f32", "bf16"):
            raise ValueError(f"invalid table_dtype {self.table_dtype!r}")

    @property
    def model_name(self) -> str:
        if self.use_logit:
            return "LR"
        shallow = ("FM" if self.use_fm else "FFM" if self.use_ffm
                   else "FwFM" if self.use_fwfm else "")
        if self.use_deep:
            return ("Deep" + shallow) if shallow else "DNN"
        return shallow

    @property
    def deep_layers(self) -> Tuple[int, ...]:
        return (self.deep_nodes,) * self.h_depth

    @property
    def num_categorical(self) -> int:
        return self.field_size - self.numerical

    @property
    def use_shallow(self) -> bool:
        return self.use_logit or self.use_fm or self.use_ffm or self.use_fwfm

    @property
    def needs_emb2(self) -> bool:
        """Whether the 2nd-order (dim-E) table exists: fm/fwfm use it, and
        deep-only uses it as the tower input."""
        return self.use_fm or self.use_fwfm or (self.use_deep and not self.use_ffm)

    @property
    def needs_emb1(self) -> bool:
        """The 1st-order (dim-1) table exists unless fwlw replaces it."""
        return (self.use_logit or self.use_fm or self.use_fwfm) and not self.use_fwlw
