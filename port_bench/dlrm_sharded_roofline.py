"""The bytes DLRM-DCNv2's sharded step must move between cards, worked out from
its configuration's shapes, and the links they cross.

Nothing here reads the program. A step on R cards of ``b`` rows each (the
global batch R·b), with the configuration's deployment (the tables of more
than ``bag_row_wise_rows`` rows row-wise over the cards, the others whole on
each): L of its C fields row-wise, with ``ids_L`` and ``ids_S`` ids a row in
the row-wise and the whole fields, bags of E float32. What must enter one card,
whatever the algorithm that moves it, for each of the three bag exchanges:

* the ids: from each other card, its rows' ids of the row-wise fields that
  this card holds (a 1/R share of them) and every id of the whole fields,
  which every card steps: (R - 1)·b·(ids_L / R + ids_S)·4 B;
* the partial bags: from each other card, its part of this card's rows'
  row-wise bags, where its block holds an id of the bag (a bag of k ids
  misses a block with (1 - 1/R)^k, and an empty part need not move):
  (R - 1)·b·Σ_f P_f·E·4 B over the row-wise fields, P_f = 1 - (1 - 1/R)^k_f
  (as much must leave it);
* the gradients: every other card's rows' bag gradients, of the row-wise
  fields for the bags that hold an id of this card's block (P_f of them) and
  of the whole fields for the update every card makes:
  (R - 1)·b·(Σ_f P_f + S)·E·4 B, S the whole fields.

P_f counts the ids as uniform over the field's rows. The bag's first id is
zipf over a hashed order of the rows, which leaves the share of bags that
touch a block, averaged over the blocks, as it is; a block that holds more
than its share of hot rows sees its own share rise and the others' fall, by
about 1% of the bytes at MLPerf's shapes. At those shapes on four cards
(b = 16,384, 152 and 62 ids, 6 of 26 fields row-wise, Σ_f P_f = 4.99) that is
19.7, 125.6 and 628.9 MB a step. The dense gradients'
all-reduce, (R - 1)/R of their 64.2 MB a direction at the least, has a metric
of its own (``dense_allreduce_device_ms``) and no share here.

``LINK_BYTES_PER_S`` is what one card's links carry a direction: on the
four-card machine ``nvidia-smi nvlink -s`` reads 18 NVLink 4 links of 26.562
GB/s on every card (PERF.md; ``nvidia-smi topo -m`` does not run there), 478.1
GB/s, where NVIDIA's figure for the H100 SXM is 450 GB/s a direction and PCIe
Gen5 x16 would give 64 GB/s. The larger figure gives the smaller least time.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from . import program_spans

LINK_BYTES_PER_S = 18 * 26.562e9
SPANS = ("device:Bags - Ids Exchange", "device:Bags - Pool Exchange",
         "device:Bags - Grad Exchange")


def _fields(cfg: Dict) -> List[bool]:
    """Whether each categorical field is row-wise."""
    return [n > cfg["bag_row_wise_rows"] for n in cfg["feature_sizes"][cfg["numerical"]:]]


def ids_bytes(cfg: Dict, batch: int, ranks: int) -> float:
    row_wise = _fields(cfg)
    ids_l = sum(k for k, rw in zip(cfg["bag_sizes"], row_wise) if rw)
    ids_s = sum(k for k, rw in zip(cfg["bag_sizes"], row_wise) if not rw)
    return (ranks - 1) * batch * (ids_l / ranks + ids_s) * 4


def touched_blocks(cfg: Dict, ranks: int) -> float:
    """Σ_f P_f over the row-wise fields: the bags a row has that hold an id of
    a given block, in expectation."""
    return sum(1.0 - (1.0 - 1.0 / ranks) ** k
               for k, rw in zip(cfg["bag_sizes"], _fields(cfg)) if rw)


def pool_bytes(cfg: Dict, batch: int, ranks: int) -> float:
    return (ranks - 1) * batch * touched_blocks(cfg, ranks) * cfg["embedding_size"] * 4


def grad_bytes(cfg: Dict, batch: int, ranks: int) -> float:
    whole = sum(not rw for rw in _fields(cfg))
    return ((ranks - 1) * batch * (touched_blocks(cfg, ranks) + whole)
            * cfg["embedding_size"] * 4)


def exchange_least_seconds(cfg: Dict, batch: int, ranks: int) -> float:
    """The three bag exchanges of a step at the link's peak."""
    return (ids_bytes(cfg, batch, ranks) + pool_bytes(cfg, batch, ranks)
            + grad_bytes(cfg, batch, ranks)) / LINK_BYTES_PER_S


def exchange_ms(rec, ctx) -> Optional[float]:
    """The three bag exchanges' device ms a step: their spans in the traced
    stretch, summed, over its steps."""
    spans = program_spans.stretch(rec, ctx)
    steps = sum(s.name == SPANS[0] for s in spans or ())
    if not steps:
        return None
    return sum(s.end_ns - s.start_ns for s in spans if s.name in SPANS) * 1e-6 / steps
