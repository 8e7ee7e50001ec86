"""The port's own copies of the data layer against the JAX package's: readers,
``get_dataset``, feature maps, the native loader and preprocessing.

Every comparison is for equality, array for array: both packages run the same
host code on the same files. The synthetic directories are those of
``tests/test_datasets_synthetic.py`` (avazu, twitter) and an ali one made the
same way.
"""

import importlib.util
import os
import shutil

import numpy as np
import pytest

from xsdeepfwfm_deprecated_tpu.data import datasets as JDS
from xsdeepfwfm_deprecated_tpu.data import feature_map as JFM
from xsdeepfwfm_deprecated_tpu.data import native_loader as JNL
from xsdeepfwfm_deprecated_tpu.data import preprocess as JP
from xsdeepfwfm_deprecated_tpu.data import readers as JR
from xsdeepfwfm_deprecated_torch.data import datasets as TDS
from xsdeepfwfm_deprecated_torch.data import feature_map as TFM
from xsdeepfwfm_deprecated_torch.data import get_dataset
from xsdeepfwfm_deprecated_torch.data import native_loader as TNL
from xsdeepfwfm_deprecated_torch.data import preprocess as TP
from xsdeepfwfm_deprecated_torch.data import readers as TR
from xsdeepfwfm_deprecated_torch.utils import native_build

HAS_PANDAS = (importlib.util.find_spec("pandas") is not None
              and importlib.util.find_spec("pyarrow") is not None)
needs_pandas = pytest.mark.skipif(not HAS_PANDAS, reason="pandas with pyarrow is not installed")
HAS_CXX = shutil.which("g++") is not None


def assert_same_split(got, want):
    assert set(got) == set(want) == {"label", "value", "index", "feature_sizes"}
    assert got["feature_sizes"] == want["feature_sizes"]
    for key in ("label", "value", "index"):
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        assert np.array_equal(got[key], want[key]), key


def assert_same_dataset(name, **kw):
    want = JDS.get_dataset(name, **kw)
    got = get_dataset(name, **kw)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert_same_split(g, w)
    return got


def write_map(path, field_positions_sizes):
    with open(path, "w") as f:
        for pos, size in field_positions_sizes:
            for idx in range(1, size):
                f.write(f"{pos},{idx},{idx}\n")


def write_ali_style(root, name, n_fields, n_num, seed):
    """The ali/avazu layout: CSVs with a ``y2`` header row and float-typed
    indices, and a feature map at ``feature_dim_start=1``."""
    d = root / "large"
    d.mkdir()
    rng = np.random.default_rng(seed)
    sizes = [int(rng.integers(3, 9)) for _ in range(n_fields - n_num)]
    for split in ("train", "valid", "test"):
        rows = ["y2," + ",".join(["x"] * n_fields)]
        for _ in range(60):
            num = [f"{rng.random():.2f}" for _ in range(n_num)]
            cats = [str(float(rng.integers(0, s))) for s in sizes]
            rows.append(",".join([str(rng.integers(0, 2))] + num + cats))
        (d / f"{name}_{split}.csv").write_text("\n".join(rows) + "\n")
    write_map(str(d / f"{name}_feature_map"), [(i + n_num + 1, s) for i, s in enumerate(sizes)])
    return str(root)


def write_criteo_style(root, seed=0, rows=50):
    d = root / "large"
    d.mkdir()
    rng = np.random.default_rng(seed)
    sizes = [int(rng.integers(2, 30)) for _ in range(26)]
    for split in ("train", "valid", "test"):
        lines = []
        for _ in range(rows):
            num = [f"{rng.normal():.4f}" for _ in range(13)]
            cats = [str(rng.integers(0, s)) for s in sizes]
            lines.append(",".join([str(rng.integers(0, 2))] + num + cats))
        (d / f"criteo_{split}.csv").write_text("\n".join(lines) + "\n")
    write_map(str(d / "criteo_feature_map"), [(i + 14, s) for i, s in enumerate(sizes)])
    return str(root), sizes


@pytest.fixture(params=["native", "numpy"])
def reader(request, monkeypatch):
    """Both parsers: the native C++ loader and the numpy fallback."""
    if request.param == "numpy":
        monkeypatch.setenv("XSDEEPFWFM_NATIVE_LOADER", "0")
    elif not TNL.available():
        pytest.skip("the native loader cannot be built here")
    return request.param


def test_default_data_dir_is_the_repo_data():
    assert TDS.DEFAULT_DATA_DIR == JDS.DEFAULT_DATA_DIR
    assert os.path.exists(os.path.join(TDS.DEFAULT_DATA_DIR, "tiny_train_input.csv"))


def test_tiny_criteo_equals_the_jax_package(reader):
    field_size, train, valid, test = assert_same_dataset("tiny-criteo")
    assert TR.LAST_READER == reader
    assert field_size == 39 and train["index"].shape == (10000, 26)
    assert train["value"].shape == (10000, 13) and train["feature_sizes"][:13] == [1] * 13
    assert set(np.unique(train["label"])) <= {0.0, 1.0}
    assert all(test["index"][:, c].max() < train["feature_sizes"][13 + c] for c in range(26))
    assert valid is not test and np.array_equal(valid["index"], test["index"])


def test_criteo_directory_equals_the_jax_package(tmp_path, reader):
    root, sizes = write_criteo_style(tmp_path)
    _, train, _, _ = assert_same_dataset("criteo", data_dir=root)
    assert train["feature_sizes"] == [1] * 13 + sizes
    assert TR.LAST_READER == reader


def test_avazu_directory_equals_the_jax_package(tmp_path, reader):
    root = write_ali_style(tmp_path, "avazu", 23, 1, seed=0)
    field_size, train, _, _ = assert_same_dataset("avazu", data_dir=root)
    assert field_size == 23 and train["index"].shape == (60, 22)
    assert train["value"].shape == (60, 1)


def test_ali_directory_equals_the_jax_package(tmp_path, reader):
    root = write_ali_style(tmp_path, "ali", 32, 10, seed=1)
    field_size, train, _, _ = assert_same_dataset("ali", data_dir=root)
    assert field_size == 32 and train["index"].shape == (60, 22)
    assert train["value"].shape == (60, 10)
    assert TR.read_data_avazu is TR.read_data_ali


@needs_pandas
@pytest.mark.parametrize("category", ["like", "reply"])
def test_twitter_directory_equals_the_jax_package(tmp_path, category):
    import pandas as pd
    d = tmp_path / "large"
    d.mkdir()
    rng = np.random.default_rng(1)
    sizes = [int(rng.integers(3, 7)) for _ in range(36)]
    n = 50
    cols = {lbl: rng.integers(0, 2, n) for lbl in ("reply", "retweet", "retweet_comment", "like")}
    cols.update({f"num{i}": rng.random(n) for i in range(11)})
    cols.update({f"cat{i}": rng.integers(0, s, n) for i, s in enumerate(sizes)})
    for split in ("train", "valid", "test"):
        pd.DataFrame(cols).to_parquet(d / f"twitter_{split}_s.parquet")
    write_map(str(d / "twitter_feature_map_s"), [(i + 11 + 4, s) for i, s in enumerate(sizes)])
    field_size, train, _, _ = assert_same_dataset("twitter", data_dir=str(tmp_path),
                                                  twitter_category=category)
    assert field_size == 47 and train["value"].shape == (n, 11)
    assert train["index"].shape == (n, 36) and len(train["feature_sizes"]) == 47
    assert np.array_equal(train["label"], cols[category].astype(np.float32))


def test_unknown_dataset_raises():
    with pytest.raises(ValueError, match="unknown dataset"):
        get_dataset("movielens")


def test_skip_header_and_single_row(tmp_path):
    p = tmp_path / "h.csv"
    p.write_text("9,9,9,9\n1,0.5,3,2\n")
    want = JR.read_data(str(p), None, [1], dim=3, skip_header=True)
    got = TR.read_data(str(p), None, [1], dim=3, skip_header=True)
    assert_same_split(got, want)
    assert TR.LAST_READER == "numpy" and got["index"].shape == (1, 2)


@pytest.mark.skipif(not HAS_CXX, reason="no C++ compiler")
def test_native_loader_equals_the_jax_binding_and_refuses_bad_rows(tmp_path):
    good = tmp_path / "good.csv"
    good.write_text("y2,a,b,c\n1,0.25,4,7\n0,1.5,2,3\n")
    for a, b in zip(TNL.read_csv_arrays(str(good), [1]), JNL.read_csv_arrays(str(good), [1])):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    bad = tmp_path / "bad.csv"
    bad.write_text("1,0.25,4,7\n0,oops,2,3\n")
    with pytest.raises(IOError):
        TNL.read_csv_arrays(str(bad), [1])
    with pytest.raises(ValueError):          # the strict numpy reader takes over and refuses it
        TR.read_data(str(bad), None, [1], dim=3)


@pytest.mark.skipif(not HAS_CXX, reason="no C++ compiler")
def test_native_build_without_make_runs_the_compiler_itself(tmp_path, monkeypatch):
    """A machine without ``make``: the Makefile's one command, into the same
    path; an existing library is left alone."""
    src = os.path.join(native_build.REPO_ROOT, "native", "dataloader", "csv_loader.cpp")
    shutil.copy(src, tmp_path / "csv_loader.cpp")
    monkeypatch.setattr(native_build.shutil, "which", lambda name: None)
    out = native_build.build_shared_library(str(tmp_path), "libcsv_loader.so", "csv_loader.cpp")
    assert out == str(tmp_path / "libcsv_loader.so") and os.path.getsize(out) > 0
    stamp = os.stat(out).st_mtime_ns
    assert native_build.build_shared_library(str(tmp_path), "libcsv_loader.so",
                                             "csv_loader.cpp") == out
    assert os.stat(out).st_mtime_ns == stamp
    assert sorted(os.listdir(tmp_path)) == ["csv_loader.cpp", "libcsv_loader.so"]


def test_feature_map_functions_equal_the_jax_package(tmp_path):
    sizes = [1, 1, 5, 3, 9]
    for mod, name in ((JFM, "j"), (TFM, "t")):
        mod.write_feature_map_stub(str(tmp_path / name), sizes, num_numeric=2)
    assert (tmp_path / "j").read_text() == (tmp_path / "t").read_text()
    want = JFM.load_category_index(str(tmp_path / "j"), feature_dim_start=0, dim=5)
    got = TFM.load_category_index(str(tmp_path / "t"), feature_dim_start=0, dim=5)
    assert got == want
    assert TFM.feature_sizes_from_map(got, [1, 2]) == JFM.feature_sizes_from_map(want, [1, 2]) \
        == sizes
    csv = tmp_path / "d.csv"
    csv.write_text("1,3,7,2,0\n0,1,2,4,1\n1,9,9,0,3\n")
    assert TFM.derive_feature_sizes_from_csv([str(csv)], 2) \
        == JFM.derive_feature_sizes_from_csv([str(csv)], 2) == [1, 1, 5, 4]


# ---- preprocessing

def test_scale_numeric_and_frequency_maps_equal_the_jax_package():
    for v in (0, 1, 2, 2.5, 3, 100, 1e6, "", None, "17"):
        assert TP.scale_numeric(v) == JP.scale_numeric(v)
    rows = [["1", "a", "x"], ["1", "a", "y"], ["1", "b", "x"], ["2", "a", ""], ["2", "c", ""]]
    assert TP.build_frequency_maps(rows, 1, cutoff=2) == JP.build_frequency_maps(rows, 1, cutoff=2) \
        == [{"a": 1}, {"x": 1}]


def test_preprocess_criteo_writes_the_same_files(tmp_path):
    rng = np.random.default_rng(0)
    lines = []
    for _ in range(300):
        nums = [str(rng.integers(0, 50)) if rng.random() > 0.1 else "" for _ in range(13)]
        cats = [f"v{rng.integers(0, 5)}" for _ in range(26)]
        lines.append("\t".join([str(rng.integers(0, 2))] + nums + cats))
    raw = tmp_path / "train.txt"
    raw.write_text("\n".join(lines) + "\n")
    kw = dict(cutoff=4, valid_test_fraction=0.2, seed=0)
    want = JP.preprocess_criteo(str(raw), str(tmp_path / "j"), **kw)
    got = TP.preprocess_criteo(str(raw), str(tmp_path / "t"), **kw)
    for g, w in zip(got, want):
        assert os.path.basename(g) == os.path.basename(w)
        assert open(g).read() == open(w).read()
    # and the files load through the port's reader with the emitted map
    d = TR.read_data(got[0], got[3], list(range(1, 14)), feature_dim_start=1, dim=39)
    assert d["index"].shape == (240, 26) and len(d["feature_sizes"]) == 39
    assert all(d["index"][:, c].max() < d["feature_sizes"][13 + c] for c in range(26))


@needs_pandas
def test_pandas_preprocessing_equals_the_jax_package(tmp_path):
    import pandas as pd
    rng = np.random.default_rng(2)
    n = 200
    frame = pd.DataFrame({
        "reply": rng.integers(0, 2, n), "retweet": rng.integers(0, 2, n),
        "retweet_comment": rng.integers(0, 2, n), "like": rng.integers(0, 2, n),
        "d0": rng.normal(size=n), "d1": rng.random(n) * 100,
        "s0": rng.integers(0, 6, n), "s1": rng.integers(0, 40, n)})
    kw = dict(dense_features=["d0", "d1"], sparse_features=["s0", "s1"], cutoff=8, seed=3)
    want = JP.preprocess_twitter(frame, out_dir=str(tmp_path / "j"), **kw)
    got = TP.preprocess_twitter(frame, out_dir=str(tmp_path / "t"), **kw)
    for g, w in zip(got[:3], want[:3]):
        pd.testing.assert_frame_equal(g, w)
    assert got[3] == want[3]
    assert (tmp_path / "t" / "twitter_feature_map_s").read_text() \
        == (tmp_path / "j" / "twitter_feature_map_s").read_text()
    pd.testing.assert_frame_equal(pd.read_parquet(tmp_path / "t" / "twitter_test_s.parquet"),
                                  pd.read_parquet(tmp_path / "j" / "twitter_test_s.parquet"))
    vc_t, maps_t = TP.preprocess_value_counts(frame.copy(), ["s0", "s1"], cutoff=4)
    vc_j, maps_j = JP.preprocess_value_counts(frame.copy(), ["s0", "s1"], cutoff=4)
    pd.testing.assert_frame_equal(vc_t, vc_j)
    assert maps_t == maps_j
    pd.testing.assert_frame_equal(TP.min_max_scale(frame.copy(), ["d0", "d1"]),
                                  JP.min_max_scale(frame.copy(), ["d0", "d1"]))


@needs_pandas
def test_ali_join_equals_the_jax_package(tmp_path):
    import pandas as pd
    rng = np.random.default_rng(4)
    raw = pd.DataFrame({"user": rng.integers(0, 8, 40), "time_stamp": rng.integers(100, 200, 40),
                        "adgroup_id": rng.integers(0, 5, 40), "pid": rng.integers(0, 2, 40),
                        "nonclk": rng.integers(0, 2, 40), "clk": rng.integers(0, 2, 40)})
    ads = pd.DataFrame({"adgroup_id": np.arange(5), "cate_id": rng.integers(0, 3, 5),
                        "price": [1.0, np.nan, 3.5, 9.0, 2.0]})
    users = pd.DataFrame({"userid": np.arange(8), "age_level": rng.integers(0, 4, 8)})
    want = JP.preprocess_ali_join(raw.copy(), ads.copy(), users.copy(), str(tmp_path / "j.csv"))
    got = TP.preprocess_ali_join(raw.copy(), ads.copy(), users.copy(), str(tmp_path / "t.csv"))
    pd.testing.assert_frame_equal(got, want)
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()
    assert list(got.columns[:3]) == ["clk", "time_stamp", "price"] and TP.ALI_DENSE_FEATURES \
        == JP.ALI_DENSE_FEATURES
