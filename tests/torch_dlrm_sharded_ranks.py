"""The rank side of ``test_torch_dlrm_sharded.py``: what each of 4 ranks runs
on the CPU over gloo, started by ``parallel.launch.run_ranks``. Torch and the
port only (never JAX); the test process computes the one-process steps and
the plain reference from the same seeded inputs, which it builds with the
functions below.

The model: a tiny DLRM-DCNv2 whose fields of 50 and 41 rows are over the
row-wise threshold of 20 rows (blocks of 13 and 11 rows, the last rank's
short of them: pad rows) and whose fields of 7 and 9 rows are held whole on
every rank. The global batch is 4 x 16 rows, each bag with repeats inside it
and across the ranks' rows.
"""

import logging
from functools import partial

import numpy as np
import torch

from xsdeepfwfm_deprecated_torch import _tree
from xsdeepfwfm_deprecated_torch.config import ModelConfig, TrainConfig
from xsdeepfwfm_deprecated_torch.models import dlrm
from xsdeepfwfm_deprecated_torch.parallel import bag_sharding
from xsdeepfwfm_deprecated_torch.parallel import mesh as mesh_mod
from xsdeepfwfm_deprecated_torch.train import trainer
from xsdeepfwfm_deprecated_torch.utils import cuda_graph, profiling

WORLD = 4
SIZES = (1, 1, 7, 50, 9, 41)        # F=6, the first 2 numeric, 4 bags
BAGS = (1, 3, 5, 2)
THRESHOLD = 20                      # fields 1 and 3 (50 and 41 rows) row-wise
B, LR, STEPS = 16, 0.05, 3          # a rank's rows; the global batch is WORLD * B
GLOBAL = WORLD * B
CFG = {"feature_sizes": SIZES, "numerical": 2, "bag_sizes": BAGS, "embedding_size": 8,
       "dense_arch_layers": (16, 8), "dcn_num_layers": 2, "dcn_low_rank_dim": 4,
       "over_arch_layers": (16, 8, 1), "learning_rate": LR}
QUIET = logging.getLogger("torch_dlrm_sharded_ranks")
QUIET.addHandler(logging.NullHandler())
QUIET.propagate = False


def mcfg() -> ModelConfig:
    return ModelConfig(field_size=len(SIZES), feature_sizes=SIZES, numerical=2, embedding_size=8,
                       use_fwfm=False, use_deep=False, use_dlrm=True, bag_sizes=BAGS,
                       dense_arch_layers=(16, 8), dcn_num_layers=2, dcn_low_rank_dim=4,
                       over_arch_layers=(16, 8, 1), bag_row_wise_rows=THRESHOLD)


def tcfg(**kw) -> TrainConfig:
    return TrainConfig(**{"batch_size": GLOBAL, "optimizer_type": "adag", "learning_rate": LR,
                          "weight_decay": 0.0, **kw})


def params(seed: int = 0):
    """The program's init, the table scaled up to N(0, 0.5²) and the cross
    biases drawn, so that the bags and every leaf move the logit."""
    p = dlrm.init_params(torch.Generator().manual_seed(seed), mcfg(), device="cpu")
    p["bags"]["dense"].mul_(50.0)
    g = torch.Generator().manual_seed(seed + 100)
    for layer in p["cross"]["layers"]:
        layer["b"].copy_(0.1 * torch.randn(layer["b"].shape, generator=g))
    return p


def batches(n: int = STEPS, seed: int = 1):
    """``n`` global batches (xi int32, xv, y): ids past each field's rows too
    (clipped to its last), repeats inside a bag and across rows (the row
    ``GLOBAL / 2`` on repeats row 0 on: each rank's rows meet another's)."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        cols = [torch.randint(0, SIZES[2 + f] + 2, (GLOBAL, 1), generator=g)
                for f, k in enumerate(BAGS) for _ in range(k)]
        xi = torch.cat(cols, dim=1)
        xi[:, 5] = xi[:, 4]
        xi[GLOBAL // 2:] = xi[:GLOBAL // 2]
        xv = torch.randn((GLOBAL, 2), generator=g)
        y = (torch.rand((GLOBAL,), generator=g) < 0.3).float()
        out.append((xi.to(torch.int32), xv, y))
    return out


def local(batch, rank: int):
    xi, xv, y = batch
    rows = slice(rank * B, (rank + 1) * B)
    return {"xi": xi[rows], "xv": xv[rows], "y": y[rows], "mask": torch.ones(B),
            "count": torch.tensor(float(GLOBAL))}


def _copy(tree):
    return _tree.tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def rank_cases(rank: int, device: torch.device):
    out = {}
    mesh = mesh_mod.make_mesh(data=WORLD, model=1, device=device)
    spec = dlrm.make_bag_spec(mcfg())
    bags = bag_sharding.ShardedBags(mesh, spec, THRESHOLD)
    p = bags.placement
    out["placement"] = (p.row_wise, p.blocks, p.local_offsets, p.rows, p.whole_rows)

    # the share: this rank's partial pools of the row-wise fields over the global batch
    full = params()
    table = bags.shard(full)["bags"]["dense"]
    xi = batches(1)[0][0]
    rows = bag_sharding.local_rows(p, xi, table.shape[0])
    out["partial_pools"] = bags._pool(table, rows, True)
    out["held_rows"] = rows
    packed = xi.long().clamp(min=0).minimum(torch.tensor([SIZES[2 + f] - 1 for f in
                                                          spec.column_field]))
    packed = packed + torch.tensor([spec.offsets[f] for f in spec.column_field])
    out["packed_rows_agree"] = torch.equal(
        bag_sharding.packed_to_local(p, packed, table.shape[0]), rows)

    # three sharded steps through make_train_step on the mesh
    state_params = bags.shard(params())
    opt = trainer.make_optimizer(tcfg())
    state = bags.shard(opt.init(params()))
    step = trainer.make_train_step(mcfg(), tcfg(), opt, mesh=mesh, reduce=bags.reduce,
                                   forward_fn=partial(dlrm.forward, lookup_fn=bags.lookup))
    updated0 = cuda_graph.device_counts().get("bag_rows_updated", 0)
    bytes0 = profiling.counters()["exchange_bytes"]
    traffic0 = len(mesh.traffic)
    out["losses"] = [float(step(state_params, state, local(b, rank))) for b in batches()]
    out["rows_updated"] = cuda_graph.device_counts()["bag_rows_updated"] - updated0
    out["exchange_bytes"] = profiling.counters()["exchange_bytes"] - bytes0
    out["traffic"] = mesh.traffic[traffic0:]
    out["table"] = _copy(state_params["bags"]["dense"])
    out["gathered"] = _copy(bags.gather(state_params))
    out["gathered_state"] = _copy(bags.gather(state))

    # the spans of a traced sharded step
    profiling.spans()
    with profiling.tracing():
        step(state_params, state, local(batches(1, seed=9)[0], rank))
        spans = profiling.spans()
    out["spans"] = [(s.name, s.span_id, s.parent_id) for s in spans]

    # DLRMEstimator.fit at -mesh_data 4, then unshard: refused where the tables do not fit
    est = trainer.DLRMEstimator(mcfg(), tcfg(mesh_data=WORLD, n_epochs=1, eval_batch_size=32),
                                logger=QUIET, device=device)
    est.params = params(seed=2)
    xi, xv, y = (torch.cat(t) for t in zip(*batches(2, seed=6)))
    est.fit(xi.numpy(), xv.numpy(), y.numpy())
    out["fit_losses"] = list(est.last_epoch_losses)
    out["fit_logits"] = est._predict_logits(xi.numpy(), xv.numpy())
    room = bag_sharding.room_bytes
    bag_sharding.room_bytes = lambda dev: 1000
    try:
        est.unshard()
    except ValueError as err:
        out["unshard_refused"] = str(err)
    finally:
        bag_sharding.room_bytes = room
    out["fit_params"] = _copy(est.unshard().params)
    out["fit_blocks_left"] = est.mesh is None and not est._blocks
    return out


def one_device_steps(seed: int = 0):
    """The one-process program's three steps on the global batches: losses,
    parameters, optimizer state, the count of rows updated and the bytes its
    collectives sent."""
    prm = params(seed)
    opt = trainer.make_optimizer(tcfg())
    state = opt.init(prm)
    step = trainer.make_train_step(mcfg(), tcfg(), opt)
    updated0 = cuda_graph.device_counts().get("bag_rows_updated", 0)
    bytes0 = profiling.counters()["exchange_bytes"]
    losses = [float(step(prm, state, {"xi": xi, "xv": xv, "y": y, "mask": torch.ones(GLOBAL)}))
              for xi, xv, y in batches()]
    return {"losses": losses, "params": prm, "state": state,
            "rows_updated": cuda_graph.device_counts()["bag_rows_updated"] - updated0,
            "exchange_bytes": profiling.counters()["exchange_bytes"] - bytes0}


def owned_distinct(rank: int) -> int:
    """The benchmark-side count of what rank ``rank`` should step: each step's
    distinct rows that it holds (every whole table's, its blocks')."""
    spec = dlrm.make_bag_spec(mcfg())
    p = bag_sharding.BagPlacement(spec, WORLD, rank, THRESHOLD)
    col = np.array(spec.column_field)
    total = 0
    for xi, _, _ in batches():
        ids = np.minimum(np.maximum(xi.numpy().astype(np.int64), 0),
                         np.array([spec.feature_sizes[f] - 1 for f in col]))
        held = set()
        for c, f in enumerate(col):
            lo, hi = p.held(int(f))
            for i in ids[:, c]:
                if lo <= i < hi:
                    held.add((int(f), int(i)))
        total += len(held)
    return total
