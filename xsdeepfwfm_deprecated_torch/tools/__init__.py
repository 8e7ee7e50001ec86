"""Quality at scale: the port's counterparts of the synthetic scale runs in
``scripts/``.

Each module keeps its script's name, flags, defaults and JSON output, runs as
``python -m xsdeepfwfm_deprecated_torch.tools.<name>`` and exposes
``main(argv=None, device=None)``: ``device=None`` is the CUDA device (and
raises without one), ``device="cpu"`` runs on the CPU.

* :mod:`.synthetic_scale_run` — the planted-model generator, dense / DeepLight
  / QAT training and the oracle AUC;
* :mod:`.int8_auc_parity` — one checkpoint served in fp32, int8 layerwise and
  int8 fused;
* :mod:`.kd_scale_run` — teacher, student alone, student with KD;
* :mod:`.qr_scale_run` — dense against quotient-remainder embeddings;
* :mod:`.nfm_scale_run` — NFM with the sane and the faithful init;
* :mod:`.pruned_serving_bench` — the dense model against its pruned, compacted
  and int8 variants.
"""
