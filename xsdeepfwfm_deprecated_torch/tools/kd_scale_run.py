"""Knowledge distillation at paper scale: teacher, student alone, student+KD.

Port of ``scripts/kd_scale_run.py``, with its flags and JSON lines. The
reference's KD finding: a 400x2 student distilled from the converged DeepFwFM
teacher lands within noise of the teacher at lower latency. On the synthetic
cache of :mod:`.synthetic_scale_run` (1M rows at full-Criteo dims):

1. teacher = the paper's DeepFwFM (E=10, 400^3, lw+fwlw), ``--teacher-epochs``;
2. student A = a 400x2 tower trained alone;
3. student B = the same architecture and init trained with the DeepLight KD
   loss (alpha 0.9, T 20, the teacher's logits computed each epoch);
4. serving time of teacher and student at B=8192: the device time of one
   more forward of the compiled form, over 16 distinct full batches (modulo
   windows of the test slice) in one CUDA graph against 1 in another, 5
   replays each (``utils.profiling.marginal_timeit``).

Done when student+KD >= student alone and within 0.005 of the teacher.
``--cpu`` runs on the CPU (``main(argv, device="cpu")``).

Usage: python -m xsdeepfwfm_deprecated_torch.tools.kd_scale_run --cache synth1m.npz
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import numpy as np
import torch

from .. import _tree
from ..config import ModelConfig, TrainConfig
from ..device import DeviceLike, resolve_device
from ..models import deepfwfm
from ..serving.predictor import Predictor
from ..train.trainer import DeepFMEstimator
from ..utils.profiling import marginal_timeit

TIMED_BATCHES = 16


def window_inputs(Xi, Xv, b: int, device: torch.device, n_batches: int = TIMED_BATCHES):
    """``n_batches`` full, distinct ``b``-row batches on ``device``: modulo
    windows of the rows, so that a short slice still gives full batches."""
    n = len(Xi)
    inputs = []
    for i in range(n_batches):
        sl = np.arange(i * b, (i + 1) * b) % n
        inputs.append((torch.from_numpy(np.ascontiguousarray(Xi[sl])).to(device),
                       torch.from_numpy(np.ascontiguousarray(Xv[sl])).to(device)))
    return inputs


@torch.inference_mode()
def serving_ms(est, Xi, Xv, b=8192):
    pred = Predictor(est.params, est.mcfg, device=est.device)
    inputs = window_inputs(Xi, Xv, b, pred.device)
    return marginal_timeit(pred._fn, pred._model, inputs, reps=5) * 1e3


def best_params_on(est) -> dict:
    return _tree.tree_map(lambda t: t.to(est.device), est.best_params)


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cache", default=os.path.join(tempfile.gettempdir(), "synth1m.npz"))
    ap.add_argument("--teacher-epochs", type=int, default=2)
    ap.add_argument("--student-epochs", type=int, default=3)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (smoke tests)")
    return ap


def main(argv=None, device: DeviceLike = None) -> dict:
    """Returns the RESULT dict."""
    args = get_parser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else device)

    z = np.load(args.cache)
    xi, xv, y = z["xi"], z["xv"], z["y"]
    sizes = tuple(int(s) for s in z["feature_sizes"])
    n = len(y)
    n_test = n // 10
    te, va, tr = slice(0, n_test), slice(n_test, 2 * n_test), slice(2 * n_test, n)

    mcfg_t = ModelConfig(field_size=39, feature_sizes=sizes, numerical=13,
                         embedding_size=10, h_depth=3, deep_nodes=400,
                         use_fwfm=True, use_deep=True, use_lw=True,
                         use_fwlw=True)
    mcfg_s = dataclasses.replace(mcfg_t, deep_nodes=400, h_depth=2)

    def tcfg(epochs, seed=0):
        return TrainConfig(n_epochs=epochs, batch_size=args.batch,
                           learning_rate=1e-3, weight_decay=3e-7,
                           random_seed=seed, steps_per_call=10,
                           eval_train_rows=200000)

    def params_m(est):
        counts = deepfwfm.param_group_counts(est.params, est.mcfg)
        return counts["total"] / 1e6

    out = {}
    teacher = DeepFMEstimator(mcfg_t, tcfg(args.teacher_epochs), device=device)
    t0 = time.time()
    teacher.fit(xi[tr], xv[tr], y[tr], xi[va], xv[va], y[va], keep_best=True)
    _, t_auc, _, _ = teacher.eval_by_batch(xi[te], xv[te], y[te])
    out["teacher"] = {"test_auc": round(t_auc, 4),
                      "valid": [round(v, 4) for v in teacher.valid_result],
                      "params_m": round(params_m(teacher), 2),
                      "wall_s": round(time.time() - t0, 1)}
    print(json.dumps({"teacher": out["teacher"]}), flush=True)

    for name, kd in (("student_alone", False), ("student_kd", True)):
        est = DeepFMEstimator(mcfg_s, tcfg(args.student_epochs), device=device)
        t0 = time.time()
        est.fit(xi[tr], xv[tr], y[tr], xi[va], xv[va], y[va], keep_best=True,
                teacher_model=teacher if kd else None)
        _, auc, _, _ = est.eval_by_batch(xi[te], xv[te], y[te])
        res = {"test_auc": round(auc, 4),
               "valid": [round(v, 4) for v in est.valid_result],
               "params_m": round(params_m(est), 2),
               "wall_s": round(time.time() - t0, 1)}
        if est.best_params is not None:
            final = est.params
            est.params = best_params_on(est)
            _, ba, _, _ = est.eval_by_batch(xi[te], xv[te], y[te])
            res["best_test_auc"] = round(ba, 4)
            est.params = final
        out[name] = res
        print(json.dumps({name: res}), flush=True)
        if kd:
            out["student_serve_b8192_ms"] = round(
                serving_ms(est, xi[te], xv[te]), 3)
    out["teacher_serve_b8192_ms"] = round(serving_ms(teacher, xi[te], xv[te]), 3)

    ka = out["student_kd"].get("best_test_auc", out["student_kd"]["test_auc"])
    aa = out["student_alone"].get("best_test_auc", out["student_alone"]["test_auc"])
    ta = out["teacher"]["test_auc"]
    out["kd_minus_alone"] = round(ka - aa, 4)
    out["kd_minus_teacher"] = round(ka - ta, 4)
    out["ok"] = bool(ka >= aa - 1e-4 and ka >= ta - 0.005)
    print("RESULT " + json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
