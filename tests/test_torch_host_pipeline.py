"""The 41.3M-row data path (``tools.host_pipeline_41m``, ``tools.gen_41m_bin``)
and the offline preprocessing CLIs (``tools.preprocess_*``) against the
scripts of ``scripts/`` that they port, on the CPU at small sizes.

The scripts are loaded by path here, in the test only: the port never imports
them. The generator is held to the script's bit for bit; the card leg, run on
the CPU with a narrow model, to the pipeline's batches (a spy on the K=1
step that ``make_train_step`` makes) and to the port's own ``train_step``
over them; each CLI to the files its script writes.
"""

import itertools
import os
import tempfile

import numpy as np
import pytest
import torch

from test_preprocess import _ali_raw_tables
from test_torch_data import needs_pandas
from test_torch_scale_runs import load_script, printed, run_script
from xsdeepfwfm_deprecated_torch import _tree
from xsdeepfwfm_deprecated_torch.config import ModelConfig, TrainConfig
from xsdeepfwfm_deprecated_torch.data import native_loader
from xsdeepfwfm_deprecated_torch.data.sharded_input import ShardedBinPipeline
from xsdeepfwfm_deprecated_torch.models import deepfwfm
from xsdeepfwfm_deprecated_torch.tools import gen_41m_bin
from xsdeepfwfm_deprecated_torch.tools import host_pipeline_41m as hp
from xsdeepfwfm_deprecated_torch.tools import (preprocess_ali, preprocess_avazu,
                                               preprocess_criteo, preprocess_twitter)
from xsdeepfwfm_deprecated_torch.train import trainer as TT

ROWS = 5000          # crosses the seam of 2,000-row chunks twice
CARD_KEYS = {"card_steps", "card_wall_s", "card_step_ms", "card_step_budget_s",
             "wall_over_budget", "host_is_bottleneck", "h2d_gb_per_s", "card_step_ms_staged",
             "card_staged_budget_s", "wall_over_staged_budget"}


@pytest.fixture(scope="module")
def bin_dirs(tmp_path_factory):
    """The port's and the script's 5,000-row datasets (chunks of 2,000) and
    the feature sizes each returned."""
    root = tmp_path_factory.mktemp("bin")
    jax_gen = load_script("host_pipeline_41m").generate
    sizes = {}
    for name, gen in (("torch", hp.generate), ("jax", jax_gen)):
        sizes[name], _ = printed(gen, str(root / name), ROWS, chunk=2000)
    return root / "torch", root / "jax", sizes


def test_generate_equals_the_script_bit_for_bit(bin_dirs):
    mine, theirs, sizes = bin_dirs
    assert sizes["torch"] == sizes["jax"] == [1] * 13 + hp.FULL_CRITEO_CAT_SIZES
    for name in ShardedBinPipeline.FILES:
        assert (mine / f"{name}.npy").read_bytes() == (theirs / f"{name}.npy").read_bytes(), name
    p = ShardedBinPipeline(str(mine))
    assert p.local_rows == ROWS and p.arrays["index"].shape == (ROWS, 26)
    assert 0 < p.arrays["label"].mean() < 1


def test_host_stream_counts_whole_batches(bin_dirs):
    res = hp.host_stream_rate(str(bin_dirs[0]), 512)
    assert res["host_rows"] == ROWS // 512 * 512 and res["host_rows_per_s"] > 0


def test_native_ingest_rate_on_a_sample(bin_dirs):
    if not native_loader.available():
        pytest.skip("the native CSV loader does not build on this machine")
    res = hp.native_ingest_rate(str(bin_dirs[0]), sample_rows=2000)
    assert set(res) == {"native_csv_rows_per_s", "native_csv_mb_per_s"}
    assert res["native_csv_rows_per_s"] > 0
    assert not os.path.exists(bin_dirs[0] / "sample_shard.csv")


def test_gen_41m_bin_writes_once(tmp_path):
    d = str(tmp_path / "bin")
    _, out = printed(gen_41m_bin.main, ["--rows", "3000", "--dir", d])
    assert out.splitlines()[-1] == "done"
    assert np.load(os.path.join(d, "feature_sizes.npy")).tolist() \
        == [1] * 13 + hp.FULL_CRITEO_CAT_SIZES
    assert ShardedBinPipeline(d).local_rows == 3000
    _, out = printed(gen_41m_bin.main, ["--rows", "3000", "--dir", d])
    assert out == "already generated\n"


def test_a_set_of_another_size_or_half_written_is_refused(tmp_path):
    d = str(tmp_path / "bin")
    printed(gen_41m_bin.main, ["--rows", "3000", "--dir", d])
    for main in (gen_41m_bin.main, hp.main):
        with pytest.raises(ValueError, match="holds 3,000 rows, not 4,000"):
            printed(main, ["--rows", "4000", "--dir", d, *(["--skip-native"] * (main is hp.main))])
    os.remove(os.path.join(d, "feature_sizes.npy"))
    for main in (gen_41m_bin.main, hp.main):
        with pytest.raises(ValueError, match="half-written"):
            printed(main, ["--rows", "3000", "--dir", d])


def test_default_dir_follows_the_temporary_directory(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    want = os.path.join(str(tmp_path), "synth41m_bin")
    assert hp.default_dir() == want and hp.get_parser().parse_args([]).dir == want


def test_main_host_legs_print_the_scripts_lines(tmp_path):
    d = str(tmp_path / "bin")
    res, out = printed(hp.main, ["--rows", "3000", "--dir", d, "--batch", "512",
                                 "--skip-native"])
    lines = out.splitlines()
    assert lines[0] == f"generating 3,000 rows into {d} ..."
    assert lines[-1].startswith("RESULT {") and res["rows"] == 3000
    assert res["host_rows"] == 3000 // 512 * 512 and not CARD_KEYS & set(res)


def small_bin(root, rows: int, sizes, seed: int) -> None:
    """A bin dataset of ``rows`` seeded rows over ``sizes`` (13 numeric fields)."""
    rng = np.random.default_rng(seed)
    w = ShardedBinPipeline.create(root, rows, 13, len(sizes) - 13)
    w["index"][:] = np.stack([rng.integers(0, s, rows) for s in sizes[13:]], 1)
    w["value"][:] = rng.normal(size=(rows, 13))
    w["label"][:] = rng.random(rows) < 0.3
    for a in w.values():
        a.flush()


def test_card_epoch_trains_on_exactly_the_pipelines_batches(tmp_path, monkeypatch):
    sizes = [1] * 13 + [7, 30, 5, 60] * 6 + [9, 11]
    d = str(tmp_path / "bin")
    small_bin(d, 300, sizes, seed=0)
    cfg = ModelConfig(field_size=39, feature_sizes=tuple(sizes), numerical=13, embedding_size=4,
                      h_depth=2, deep_nodes=16, use_fwfm=True, use_deep=True, use_lw=True,
                      use_fwlw=True)
    seen = []
    make = hp.make_train_step

    def spy(*args, **kw):       # the K=1 step, which records each batch it is given
        step = make(*args, **kw)

        def recorded(params, opt_state, batch, generator=None):
            seen.append({k: v.clone() for k, v in batch.items()})
            return step(params, opt_state, batch, generator)
        return recorded

    monkeypatch.setattr(hp, "make_train_step", spy)
    res, params = hp.card_epoch(d, sizes, 64, 1, 4, mcfg=cfg, device="cpu")

    assert CARD_KEYS <= set(res) and res["card_steps"] == 4 and res["h2d_gb_per_s"] is None
    assert res["card_device"] == "cpu"
    # the criterion on the ratio the tool reports to 3 decimals: the wall and the budget are
    # reported to 0.1 s, too coarse for it on the CPU's sub-second epochs
    assert res["host_is_bottleneck"] == (res["wall_over_budget"] > 1.15)
    want = list(itertools.islice(ShardedBinPipeline(d).epoch_batches(64, seed=4, epoch=0), 4))
    # the epoch, the budget on its last batch, then the staged budget over its batches in order
    staged = [want[i % len(want)] for i in range(hp.BUDGET_REPS)]
    assert len(seen) == 4 + 2 * hp.BUDGET_REPS
    for got, b in zip(seen, want + [want[-1]] * hp.BUDGET_REPS + staged):
        assert np.array_equal(got["xi"].numpy(), b["index"])
        assert np.array_equal(got["xv"].numpy(), b["value"])
        assert np.array_equal(got["y"].numpy(), b["label"])
        assert torch.equal(got["mask"], torch.ones(64))

    ref = deepfwfm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    tcfg = TrainConfig(batch_size=64, steps_per_call=1)
    opt = TT.make_optimizer(tcfg)
    state = opt.init(ref)
    gen = torch.Generator().manual_seed(1)
    for batch in seen:
        TT.train_step(ref, state, batch, cfg, tcfg, opt, generator=gen)
    for got, w in zip(_tree.leaves(params), _tree.leaves(ref)):
        torch.testing.assert_close(got, w, rtol=0, atol=1e-6)


# ---- the preprocessing CLIs against their scripts


def same_files(mine, theirs, parquet=False):
    names = sorted(os.listdir(theirs))
    assert sorted(os.listdir(mine)) == names and names
    for name in names:
        if parquet and name.endswith(".parquet"):
            import pandas as pd
            pd.testing.assert_frame_equal(pd.read_parquet(mine / name),
                                          pd.read_parquet(theirs / name))
        else:
            assert (mine / name).read_bytes() == (theirs / name).read_bytes(), name


def both(tool, script, argv_of, tmp_path, monkeypatch):
    """Run the port's CLI and its script with ``argv_of(out_dir)``; the
    output directories and what each printed, with the directory named OUT."""
    mine, theirs = tmp_path / "torch", tmp_path / "jax"
    _, said = printed(tool.main, argv_of(str(mine)))
    said_j = run_script(load_script(script), argv_of(str(theirs)), monkeypatch)
    assert said.replace(str(mine), "OUT") == said_j.replace(str(theirs), "OUT")
    return mine, theirs


def test_preprocess_criteo_cli_writes_the_scripts_files(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    lines = []
    for _ in range(300):
        nums = [str(rng.integers(0, 50)) if rng.random() > 0.1 else "" for _ in range(13)]
        cats = [f"v{rng.integers(0, 5)}" for _ in range(26)]
        lines.append("\t".join([str(rng.integers(0, 2))] + nums + cats))
    raw = tmp_path / "train.txt"
    raw.write_text("\n".join(lines) + "\n")
    mine, theirs = both(preprocess_criteo, "preprocess_criteo",
                        lambda out: [str(raw), out, "--valid-test-fraction", "0.2", "--seed", "1"],
                        tmp_path, monkeypatch)
    same_files(mine, theirs)


@needs_pandas
def test_preprocess_avazu_cli_writes_the_scripts_files(tmp_path, monkeypatch):
    import pandas as pd
    rng = np.random.default_rng(1)
    n = 400
    raw = tmp_path / "train.csv"
    pd.DataFrame({"id": np.arange(n), "click": rng.integers(0, 2, n),
                  "hour": rng.integers(14102100, 14102124, n),
                  "C1": rng.integers(1000, 1012, n), "banner_pos": rng.integers(0, 4, n),
                  "site_id": [f"s{v}" for v in rng.integers(0, 30, n)],
                  "device_type": rng.integers(0, 3, n)}).to_csv(raw, index=False)
    mine, theirs = both(preprocess_avazu, "preprocess_avazu",
                        lambda out: [str(raw), out, "--cutoff", "4", "--seed", "2"],
                        tmp_path, monkeypatch)
    same_files(mine, theirs)


@needs_pandas
def test_preprocess_ali_cli_writes_the_scripts_files(tmp_path, monkeypatch):
    raw_sample, ad_feature, user_profile = _ali_raw_tables()
    raw = tmp_path / "raw"
    raw.mkdir()
    for name, frame in (("raw_sample", raw_sample), ("ad_feature", ad_feature),
                        ("user_profile", user_profile)):
        frame.to_csv(raw / f"{name}.csv", index=False)
    tables = [str(raw / f"{n}.csv") for n in ("raw_sample", "ad_feature", "user_profile")]
    mine, theirs = both(preprocess_ali, "preprocess_ali", lambda out: ["join", *tables, out],
                        tmp_path, monkeypatch)
    same_files(mine, theirs)
    joined = str(theirs / "ali_click.csv")
    mine, theirs = both(preprocess_ali, "preprocess_ali",
                        lambda out: ["map", joined, out, "--n-dense", "2", "--no-header",
                                     "--sample-frac", "0.8", "--seed", "3"],
                        tmp_path / "map", monkeypatch)
    same_files(mine, theirs)


@needs_pandas
def test_preprocess_twitter_cli_writes_the_scripts_files(tmp_path, monkeypatch):
    import pandas as pd
    rng = np.random.default_rng(3)
    n = 300
    raw = tmp_path / "raw.csv"
    pd.DataFrame({"reply": rng.integers(0, 2, n), "retweet": rng.integers(0, 2, n),
                  "retweet_comment": rng.integers(0, 2, n), "like": rng.integers(0, 2, n),
                  "d0": rng.random(n) * 100, "d1": rng.random(n) * 5,
                  "s0": [f"a{v}" for v in rng.integers(0, 6, n)],
                  "s1": rng.integers(0, 40, n)}).to_csv(raw, index=False)
    mine, theirs = both(preprocess_twitter, "preprocess_twitter",
                        lambda out: [str(raw), out, "--dense-cols", "d0", "d1", "--cutoff", "2"],
                        tmp_path, monkeypatch)
    same_files(mine, theirs, parquet=True)
