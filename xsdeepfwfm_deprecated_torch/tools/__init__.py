"""Quality and data at scale: the port's counterparts of the synthetic scale
runs, the 41.3M-row binary pipeline and the offline preprocessing CLIs in
``scripts/``.

Each module keeps its script's name, flags, defaults and JSON output, runs as
``python -m xsdeepfwfm_deprecated_torch.tools.<name>`` and exposes
``main(argv=None, device=None)``: ``device=None`` is the CUDA device (and
raises without one), ``device="cpu"`` runs on the CPU. The host-only tools
(:mod:`.gen_41m_bin` and the four ``preprocess_*``) take no device:
``main(argv=None)``.

* :mod:`.synthetic_scale_run` — the planted-model generator, dense / DeepLight
  / QAT training and the oracle AUC;
* :mod:`.int8_auc_parity` — one checkpoint served in fp32, int8 layerwise and
  int8 fused;
* :mod:`.kd_scale_run` — teacher, student alone, student with KD;
* :mod:`.qr_scale_run` — dense against quotient-remainder embeddings;
* :mod:`.nfm_scale_run` — NFM with the sane and the faithful init;
* :mod:`.pruned_serving_bench` — the dense model against its pruned, compacted
  and int8 variants;
* :mod:`.host_pipeline_41m` — the 41.3M-row binary dataset: native CSV ingest,
  the host epoch stream, and (``--card``) the stream feeding the train step;
* :mod:`.gen_41m_bin` — that dataset generated ahead, on the host;
* :mod:`.preprocess_criteo`, :mod:`.preprocess_avazu`, :mod:`.preprocess_ali`,
  :mod:`.preprocess_twitter` — thin CLIs over :mod:`..data.preprocess`.
"""
