"""Configuration: the port's own copy of ``ModelConfig``, ``TrainConfig`` and
the CLI parser.

Same fields, defaults, derived properties, checks and flags as
``xsdeepfwfm_deprecated_tpu/config.py``, so a config or a command line built
for one package builds the same model and the same run in the other.
``-steps_per_call`` K > 1 sets the JAX package's dispatch form: ``fit`` steps
K batches a dispatch (one CUDA graph replay on the card, on one device and on
a mesh over NCCL; over gloo the K steps of a group run eagerly), with the
results of K = 1. Flags that only choose a TPU layout (``-table_layout``,
``-mesh_table_layout``) are accepted and change no result here.
``-mesh_data``/``-mesh_model``/``-exchange`` shard a fit over ranks started
by ``torchrun`` (``parallel/mesh.py``).

Two models are the port's own, beside the JAX package's families: xDeepFM
(``use_cin``, ``-use_cin 1 -cin_layers 200,200,200``; Lian et al., KDD 2018),
its Compressed Interaction Network over the second-order embeddings with a
first-order linear part and a bias, with or without the deep tower; and
DLRM-DCNv2 (``use_dlrm``, MLPerf's recommendation model: multi-hot bags of
``bag_sizes`` ids a categorical field, a dense arch for the numeric fields, a
low-rank cross network and an over arch; ``-use_dlrm 1 -use_fwfm 0 -use_deep 0
-optimizer_type adag -l2 0``; on a ``-mesh_data`` mesh its bag tables of more
than ``-bag_row_wise_rows`` rows are cut row-wise over the ranks,
``parallel/bag_sharding.py``). Their fields and flags, with
``-optimizer_type``, are the only ones the JAX package lacks.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Static model architecture config.

    Exactly one of ``use_logit / use_fm / use_ffm / use_fwfm`` may be set;
    ``use_deep`` composes with any of them (DeepFM / DeepFFM / DeepFwFM) or
    stands alone. ``use_cin`` (xDeepFM, or the CIN alone without
    ``use_deep``) takes none of the four: its logit is a bias, a first-order
    linear part (``emb1``) and the CIN's ``cin_layers`` feature maps.
    ``use_dlrm`` (DLRM-DCNv2) takes none of them and no tower: each
    categorical field is a bag of ``bag_sizes[f]`` ids summed into one
    ``embedding_size`` row, the ``numerical`` values feed the dense arch
    (``dense_arch_layers``, ReLU after each, ending at ``embedding_size``), the
    dense output and the bags are crossed by ``dcn_num_layers`` low-rank layers
    of rank ``dcn_low_rank_dim``, and the over arch (``over_arch_layers``,
    ReLU after each but the last, which is 1) gives the logit.
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
    use_cin: bool = False    # xDeepFM's Compressed Interaction Network
    cin_layers: Tuple[int, ...] = ()   # feature maps of each CIN layer, H_1..H_L
    use_dlrm: bool = False   # DLRM-DCNv2: multi-hot bags, dense arch, low-rank cross, over arch
    bag_sizes: Tuple[int, ...] = ()          # ids a categorical field's bag holds
    dense_arch_layers: Tuple[int, ...] = ()  # the dense arch's widths, the last embedding_size
    dcn_num_layers: int = 0                  # low-rank cross layers
    dcn_low_rank_dim: int = 0                # their rank
    over_arch_layers: Tuple[int, ...] = ()   # the over arch's widths, the last 1
    bag_row_wise_rows: int = 1_000_000       # on a -mesh_data mesh a bag table of more rows is
                                             # cut row-wise over the ranks, the rest held whole

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
        if n_shallow == 0 and not (self.use_deep or self.use_cin or self.use_dlrm):
            raise ValueError("choose at least one of (logit, fm, ffm, fwfm, deep, cin, dlrm)")
        if self.use_dlrm:
            self._check_dlrm(n_shallow)
        elif (self.bag_sizes or self.dense_arch_layers or self.dcn_num_layers
              or self.dcn_low_rank_dim or self.over_arch_layers):
            raise ValueError("bag_sizes, the arches and the cross layers are given without "
                             "use_dlrm")
        if self.use_cin:
            if n_shallow:
                raise ValueError("use_cin brings its own linear part: set none of "
                                 "use_logit/use_fm/use_ffm/use_fwfm")
            if not self.cin_layers or min(self.cin_layers) < 1:
                raise ValueError(f"use_cin needs cin_layers of positive widths, "
                                 f"got {self.cin_layers!r}")
            if self.quantization_aware:
                raise ValueError("quantization-aware training does not take use_cin: "
                                 "its fake-quant tower has no CIN")
        elif self.cin_layers:
            raise ValueError("cin_layers is given without use_cin")
        if len(self.feature_sizes) != self.field_size:
            raise ValueError(
                f"feature_sizes has {len(self.feature_sizes)} entries, expected {self.field_size}")
        if self.qr_flag and self.qr_operation not in ("mult", "add", "concat"):
            raise ValueError(f"invalid qr_operation {self.qr_operation!r}")
        if self.table_dtype not in ("f32", "bf16"):
            raise ValueError(f"invalid table_dtype {self.table_dtype!r}")

    def _check_dlrm(self, n_shallow: int) -> None:
        if n_shallow or self.use_deep or self.use_cin:
            raise ValueError("use_dlrm brings its own arches and cross network: set none of "
                             "use_logit/use_fm/use_ffm/use_fwfm/use_deep/use_cin")
        if self.quantization_aware:
            raise ValueError("quantization-aware training does not take use_dlrm: its "
                             "fake-quant tower has no bags and no cross network")
        if self.qr_flag or self.table_dtype != "f32":
            raise ValueError("use_dlrm keeps its bag tables in float32, without QR")
        if len(self.bag_sizes) != self.num_categorical or min(self.bag_sizes, default=0) < 1:
            raise ValueError(f"use_dlrm needs a positive bag size for each of the "
                             f"{self.num_categorical} categorical fields, got {self.bag_sizes!r}")
        if not self.dense_arch_layers or self.dense_arch_layers[-1] != self.embedding_size:
            raise ValueError(f"use_dlrm's dense arch must end at embedding_size "
                             f"{self.embedding_size}, got {self.dense_arch_layers!r}")
        if not self.over_arch_layers or self.over_arch_layers[-1] != 1:
            raise ValueError(f"use_dlrm's over arch must end in one logit, got "
                             f"{self.over_arch_layers!r}")
        if self.dcn_num_layers < 1 or self.dcn_low_rank_dim < 1:
            raise ValueError("use_dlrm needs dcn_num_layers and dcn_low_rank_dim of at least 1")
        if min(self.dense_arch_layers + self.over_arch_layers) < 1:
            raise ValueError("use_dlrm's arch widths must be positive")

    @property
    def model_name(self) -> str:
        if self.use_dlrm:
            return "DLRM-DCNv2"
        if self.use_cin:
            return "xDeepFM" if self.use_deep else "CIN"
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
    def index_columns(self) -> int:
        """Columns of a row's ids (``Xi``): one a categorical field, or each
        field's bag of ids in turn under ``use_dlrm``."""
        return sum(self.bag_sizes) if self.use_dlrm else self.num_categorical

    @property
    def use_shallow(self) -> bool:
        return self.use_logit or self.use_fm or self.use_ffm or self.use_fwfm

    @property
    def needs_emb2(self) -> bool:
        """Whether the 2nd-order (dim-E) table exists: fm/fwfm use it, and
        deep-only uses it as the tower input."""
        return (self.use_fm or self.use_fwfm or self.use_cin
                or (self.use_deep and not self.use_ffm))

    @property
    def needs_emb1(self) -> bool:
        """The 1st-order (dim-1) table exists unless fwlw replaces it; the CIN's
        linear part always reads it."""
        return self.use_cin or ((self.use_logit or self.use_fm or self.use_fwfm)
                                and not self.use_fwlw)


@dataclass(frozen=True)
class TrainConfig:
    """Training-loop configuration (the reference ``fit`` arguments and parser
    defaults)."""

    n_epochs: int = 8
    batch_size: int = 2048
    learning_rate: float = 1e-3
    momentum: float = 0.0
    optimizer_type: str = "adam"     # adam | sgd | rmsp | adag
    weight_decay: float = 3e-7       # L2, added to the gradient before the moment updates
    random_seed: int = 42
    loss_type: str = "logloss"

    # DeepLight pruning
    prune: bool = False
    prune_fm: bool = True
    prune_deep: bool = True
    prune_r: bool = False
    sparse: float = 0.9              # target sparsity
    warm: float = 10                 # warm-up epochs before pruning starts
    emb_r: float = 1.0               # embedding sparsity ratio vs deep
    emb_corr: float = 1.0            # R-matrix sparsity ratio vs deep
    prune_interval: int = 10         # refresh every N iterations
    prune_deep_structured: bool = False  # prune whole DNN units (column L2), so that
                                     # compaction yields a smaller dense tower
    prune_damping: float = 0.99      # adaptive schedule damping D
    prune_omega: float = 100.0       # adaptive schedule Omega

    # Knowledge distillation
    kd: bool = False
    kd_alpha: float = 0.9
    kd_temperature: float = 20.0

    steps_per_call: int = 1          # train steps a dispatch: one CUDA graph replay of K
                                     # steps on the card (a mesh: over NCCL), the same
                                     # parameters
    table_layout: str = "super"      # super | flat: accepted; the port trains the flat
                                     # table, which gives the same parameters
    eval_train_rows: int = 0         # cap rows for the per-epoch train-metric eval
                                     # (0 = the full train set)
    mesh_data: int = 1               # data-parallel mesh axis (0: the ranks model leaves)
    mesh_model: int = 1              # model-parallel mesh axis: the tables' row shards
    exchange: str = "a2a_grid"       # a2a_grid | a2a | psum: lookup exchange on a mesh
    mesh_table_layout: str = "flat"  # flat | super: accepted, as table_layout
    early_stopping: bool = False
    greater_is_better: bool = True
    eval_batch_size: int = 8192
    verbose: bool = False
    save_model_path: Optional[str] = None
    checkpoint_backend: str = "npz"  # the port writes npz only; "orbax" raises

    def adaptive_sparse(self, n_iter: int) -> float:
        """Adaptive pruning schedule s_t = S * (1 - D^(t/Omega))."""
        return self.sparse * (1.0 - self.prune_damping ** (n_iter / self.prune_omega))


def get_parser() -> argparse.ArgumentParser:
    """The reference CLI parser, flag for flag, with the JAX package's
    extensions. Dead reference flags (-use_multi, -ensemble, -gpu) are kept
    for CLI compatibility and consumed by nothing."""
    p = argparse.ArgumentParser(description="Hyperparameter tuning and selection (PyTorch port)")
    p.add_argument("-c", default="DeepFwFM", type=str, help="Models: FM, DeepFwFM ...")
    p.add_argument("-use_cuda", default=0, type=int,
                   help="Compat flag; the port runs on the CUDA device unless asked for the CPU")
    p.add_argument("-gpu", default=0, type=int, help="Dead flag (parity)")
    p.add_argument("-n_epochs", default=8, type=int)
    p.add_argument("-numerical", default=13, type=int, help="Numerical features, 13 for Criteo")
    p.add_argument("-use_multi", default=0, type=int, help="Dead flag (parity)")
    p.add_argument("-use_logit", default=0, type=int)
    p.add_argument("-use_fm", default=0, type=int)
    p.add_argument("-use_fwlw", default=0, type=int)
    p.add_argument("-use_lw", default=1, type=int)
    p.add_argument("-use_ffm", default=0, type=int)
    p.add_argument("-use_fwfm", default=1, type=int)
    p.add_argument("-use_deep", default=1, type=int)
    p.add_argument("-num_deeps", default=1, type=int)
    p.add_argument("-deep_nodes", default=400, type=int)
    p.add_argument("-h_depth", default=3, type=int)
    p.add_argument("-prune", default=0, type=int)
    p.add_argument("-prune_r", default=0, type=int)
    p.add_argument("-prune_deep", default=1, type=int)
    p.add_argument("-prune_deep_structured", default=0, type=int,
                   help="Prune whole DNN units instead of elements (enables serve-time "
                        "tower compaction)")
    p.add_argument("-prune_fm", default=1, type=int)
    p.add_argument("-emb_r", default=1.0, type=float)
    p.add_argument("-emb_corr", default=1.0, type=float)
    p.add_argument("-sparse", default=0.9, type=float)
    p.add_argument("-warm", default=10, type=float)
    p.add_argument("-ensemble", default=0, type=int, help="Dead flag (parity)")
    p.add_argument("-embedding_size", default=10, type=int)
    p.add_argument("-batch_size", default=2048, type=int)
    p.add_argument("-random_seed", default=42, type=int)
    p.add_argument("-learning_rate", default=0.001, type=float)
    p.add_argument("-momentum", default=0, type=float)
    p.add_argument("-l2", default=3e-7, type=float)
    p.add_argument("-dataset", default="criteo", type=str,
                   choices=["criteo", "tiny-criteo", "twitter", "ali", "avazu"])
    p.add_argument("-save_model_path", default=0, type=str)
    p.add_argument("-dynamic_quantization", default=0, type=int)
    p.add_argument("-static_quantization", default=0, type=int)
    p.add_argument("-quantization_aware", default=0, type=int)
    p.add_argument("-kd", default=0, type=int)
    p.add_argument("-loss_type", default="logloss", type=str)
    p.add_argument("-emb_bag", default=0, type=int,
                   help="Compat flag; packed tables always behave like EmbeddingBag")
    p.add_argument("-qr_emb", default=0, type=int)
    p.add_argument("-qr_operation", default="mult", type=str)
    p.add_argument("-qr_collisions", default=4, type=int)
    p.add_argument("-qr_threshold", default=200, type=int)
    p.add_argument("-twitter_category", default="like", type=str,
                   choices=["reply", "retweet", "retweet_comment", "like"])
    p.add_argument("-time_on_cuda", default=0, type=int, help="Compat flag")
    # extensions of the JAX package, kept flag for flag
    p.add_argument("-prune_omega", default=100.0, type=float,
                   help="Adaptive-schedule Omega (the reference hardcodes 100)")
    p.add_argument("-steps_per_call", default=1, type=int,
                   help="Train steps a dispatch (one CUDA graph replay on the card); "
                        "changes no result")
    p.add_argument("-table_dtype", default="f32", type=str, choices=["f32", "bf16"],
                   help="Embedding-table storage dtype (bf16 halves table and moment bytes)")
    p.add_argument("-table_layout", default="super", type=str, choices=["super", "flat"],
                   help="Accepted; changes no result (the port trains the flat table)")
    p.add_argument("-mesh_data", default=1, type=int,
                   help="Data-parallel mesh axis size (0: all the ranks -mesh_model leaves); "
                        "a mesh larger than 1x1 needs one process per rank, started by torchrun")
    p.add_argument("-mesh_model", default=1, type=int,
                   help="Model-parallel mesh axis size: row shards of the embedding tables")
    p.add_argument("-exchange", default="a2a_grid", type=str,
                   choices=["a2a_grid", "a2a", "psum"],
                   help="Sharded embedding-lookup exchange: a2a_grid (tables over every rank), "
                        "a2a (over -mesh_model, batch over both axes) or psum")
    p.add_argument("-mesh_table_layout", default="flat", type=str, choices=["flat", "super"],
                   help="Accepted; changes no result")
    p.add_argument("-eval_train_rows", default=0, type=int,
                   help="Cap rows for the per-epoch train-metric eval (0 = full train set)")
    p.add_argument("-auto_resume", default=0, type=int,
                   help="Max automatic restarts of fit after a transient device or runtime "
                        "failure, resuming from the per-epoch checkpoint")
    p.add_argument("-debug_nans", default=0, type=int,
                   help="Trap NaN/Inf during fit: autograd anomaly detection and a finite "
                        "check of every step's loss (one device sync a step)")
    # the port's own model, which the JAX package does not have
    p.add_argument("-use_cin", default=0, type=int,
                   help="xDeepFM's Compressed Interaction Network (with -use_deep: xDeepFM); "
                        "set -use_fwfm 0 and the other shallow terms off")
    p.add_argument("-cin_layers", default="200,200,200", type=str,
                   help="Feature maps of each CIN layer, comma-separated (with -use_cin 1)")
    p.add_argument("-use_dlrm", default=0, type=int,
                   help="DLRM-DCNv2: multi-hot bags, dense arch, low-rank cross network and "
                        "over arch; set -use_fwfm 0 -use_deep 0 and train with "
                        "-optimizer_type adag -l2 0")
    p.add_argument("-bag_sizes", default="", type=str,
                   help="Ids a categorical field's bag holds, comma-separated, one a field "
                        "(with -use_dlrm 1; empty: one each)")
    p.add_argument("-dense_arch_layers", default="512,256,128", type=str,
                   help="The dense arch's widths, comma-separated, the last -embedding_size")
    p.add_argument("-dcn_num_layers", default=3, type=int, help="Low-rank cross layers")
    p.add_argument("-dcn_low_rank_dim", default=512, type=int, help="The cross layers' rank")
    p.add_argument("-over_arch_layers", default="1024,1024,512,256,1", type=str,
                   help="The over arch's widths, comma-separated, the last 1")
    p.add_argument("-bag_row_wise_rows", default=1_000_000, type=int,
                   help="DLRM-DCNv2 on a -mesh_data mesh: bag tables of more rows are cut "
                        "row-wise over the ranks, the others held whole on every rank")
    p.add_argument("-optimizer_type", default="adam", type=str,
                   choices=["adam", "rmsp", "adag", "sgd"],
                   help="The optimizer (DLRM-DCNv2's bags train with adag only)")
    return p


def _cin_layers(pars) -> Tuple[int, ...]:
    """``-cin_layers`` as a tuple where ``-use_cin`` is set, else (). A
    namespace without the flags (the JAX package's parser) has no CIN."""
    if not getattr(pars, "use_cin", 0):
        return ()
    return tuple(int(h) for h in pars.cin_layers.split(","))


def _widths(text: str) -> Tuple[int, ...]:
    return tuple(int(h) for h in text.split(",") if h.strip())


def _dlrm_keys(pars, field_size: int) -> dict:
    """DLRM-DCNv2's ``ModelConfig`` fields where ``-use_dlrm`` is set, else
    none. ``-bag_sizes`` left empty gives every field a bag of one id."""
    if not getattr(pars, "use_dlrm", 0):
        return {}
    bags = _widths(pars.bag_sizes) or (1,) * (field_size - pars.numerical)
    return dict(use_dlrm=True, bag_sizes=bags,
                dense_arch_layers=_widths(pars.dense_arch_layers),
                dcn_num_layers=pars.dcn_num_layers, dcn_low_rank_dim=pars.dcn_low_rank_dim,
                over_arch_layers=_widths(pars.over_arch_layers),
                bag_row_wise_rows=pars.bag_row_wise_rows)


def configs_from_args(pars, field_size: int, feature_sizes) -> Tuple[ModelConfig, TrainConfig]:
    """(ModelConfig, TrainConfig) from parsed CLI flags and the dataset's shape."""
    mcfg = ModelConfig(
        field_size=field_size,
        feature_sizes=tuple(int(s) for s in feature_sizes),
        numerical=pars.numerical,
        embedding_size=pars.embedding_size,
        use_logit=bool(pars.use_logit),
        use_fm=bool(pars.use_fm),
        use_ffm=bool(pars.use_ffm),
        use_fwfm=bool(pars.use_fwfm),
        use_deep=bool(pars.use_deep),
        use_lw=bool(pars.use_lw),
        use_fwlw=bool(pars.use_fwlw),
        use_cin=bool(getattr(pars, "use_cin", 0)),
        cin_layers=_cin_layers(pars),
        h_depth=pars.h_depth,
        deep_nodes=pars.deep_nodes,
        num_deeps=pars.num_deeps,
        qr_flag=bool(pars.qr_emb),
        qr_operation=pars.qr_operation,
        qr_collisions=pars.qr_collisions,
        qr_threshold=pars.qr_threshold,
        quantization_aware=bool(pars.quantization_aware),
        static_quantization=bool(pars.static_quantization),
        dynamic_quantization=bool(pars.dynamic_quantization),
        table_dtype=getattr(pars, "table_dtype", "f32"),
        **_dlrm_keys(pars, field_size),
    )
    tcfg = TrainConfig(
        n_epochs=pars.n_epochs,
        batch_size=pars.batch_size,
        learning_rate=pars.learning_rate,
        optimizer_type=getattr(pars, "optimizer_type", "adam"),
        momentum=pars.momentum,
        weight_decay=pars.l2,
        random_seed=pars.random_seed,
        loss_type=pars.loss_type,
        prune=bool(pars.prune),
        prune_fm=bool(pars.prune_fm),
        prune_deep=bool(pars.prune_deep),
        prune_deep_structured=bool(getattr(pars, "prune_deep_structured", 0)),
        prune_r=bool(pars.prune_r),
        sparse=pars.sparse,
        warm=pars.warm,
        emb_r=pars.emb_r,
        emb_corr=pars.emb_corr,
        kd=bool(pars.kd),
        prune_omega=getattr(pars, "prune_omega", 100.0),
        steps_per_call=getattr(pars, "steps_per_call", 1),
        table_layout=getattr(pars, "table_layout", "super"),
        mesh_data=getattr(pars, "mesh_data", 1),
        mesh_model=getattr(pars, "mesh_model", 1),
        exchange=getattr(pars, "exchange", "a2a_grid"),
        mesh_table_layout=getattr(pars, "mesh_table_layout", "flat"),
        eval_train_rows=getattr(pars, "eval_train_rows", 0),
        save_model_path=(pars.save_model_path if pars.save_model_path not in (0, "0") else None),
    )
    return mcfg, tcfg
