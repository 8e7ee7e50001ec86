"""The port's sharded input pipeline: the cases of ``tests/test_sharded_input.py``
run on ``xsdeepfwfm_deprecated_torch.data.sharded_input``, and its batches
equal to the JAX package's on the same files, process by process."""

import numpy as np
import pytest

from xsdeepfwfm_deprecated_torch.data.sharded_input import (
    ShardedBinPipeline, ShardedCsvPipeline, epoch_permutation, host_shard, shard_files)
from xsdeepfwfm_deprecated_tpu.data import sharded_input as J


def test_host_shard_partition():
    n = 103
    covered = []
    for h in range(4):
        s, e = host_shard(n, h, 4)
        covered.extend(range(s, e))
        assert (s, e) == J.host_shard(n, h, 4)
    assert covered == list(range(n))


def test_without_a_process_group_the_process_is_0_of_1():
    assert host_shard(103) == (0, 103)
    assert shard_files(["b", "a"]) == ["a", "b"]


def test_shard_files_round_robin():
    paths = [f"f{i}" for i in range(7)]
    got = [shard_files(paths, h, 3) for h in range(3)]
    assert sorted(sum(got, [])) == sorted(paths)
    assert got[0] == ["f0", "f3", "f6"]
    assert got == [J.shard_files(paths, h, 3) for h in range(3)]


def test_epoch_permutation_deterministic():
    a = epoch_permutation(100, seed=1, epoch=3)
    b = epoch_permutation(100, seed=1, epoch=3)
    c = epoch_permutation(100, seed=1, epoch=4)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    np.testing.assert_array_equal(a, J.epoch_permutation(100, seed=1, epoch=3))


@pytest.fixture
def csv_file(tmp_path):
    rng = np.random.default_rng(0)
    rows = []
    for i in range(57):
        rows.append(",".join(
            [str(i % 2)] + [f"{rng.random():.3f}" for _ in range(3)]
            + [str(rng.integers(0, 9)) for _ in range(4)]))
    p = tmp_path / "d.csv"
    p.write_text("\n".join(rows) + "\n")
    return str(p)


def test_pipeline_reads_shard(csv_file):
    pipes = [ShardedCsvPipeline(csv_file, n_numeric=3, process_index=h,
                                process_count=2) for h in range(2)]
    assert sum(p.local_rows for p in pipes) == 57
    batches = list(pipes[0].epoch_batches(batch_size=8, seed=0, epoch=0))
    assert all(b["index"].shape == (8, 4) for b in batches)
    assert all(b["value"].shape == (8, 3) for b in batches)
    # deterministic across re-instantiation (restart)
    pipe_again = ShardedCsvPipeline(csv_file, n_numeric=3, process_index=0,
                                    process_count=2)
    batches2 = list(pipe_again.epoch_batches(batch_size=8, seed=0, epoch=0))
    for b1, b2 in zip(batches, batches2):
        np.testing.assert_array_equal(b1["index"], b2["index"])


def test_pipeline_covers_all_rows(csv_file):
    pipe = ShardedCsvPipeline(csv_file, n_numeric=3, process_index=0,
                              process_count=1)
    seen = []
    for b in pipe.epoch_batches(batch_size=10, seed=0, epoch=0,
                                drop_remainder=False):
        seen.extend(b["label"].tolist())
    assert len(seen) == 57


@pytest.mark.parametrize("drop_remainder", [True, False])
def test_csv_batches_equal_the_jax_pipeline(csv_file, drop_remainder):
    for h in range(3):
        got = ShardedCsvPipeline(csv_file, 3, chunk_rows=16, process_index=h, process_count=3)
        want = J.ShardedCsvPipeline(csv_file, 3, chunk_rows=16, process_index=h,
                                    process_count=3)
        pairs = list(zip(got.epoch_batches(6, seed=2, epoch=1, drop_remainder=drop_remainder),
                         want.epoch_batches(6, seed=2, epoch=1, drop_remainder=drop_remainder)))
        assert len(pairs) == len(list(want.epoch_batches(6, 2, 1, drop_remainder)))
        for a, b in pairs:
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def _bin_dir(path, n=1000):
    w = ShardedBinPipeline.create(path, n, 3, 4)
    w["label"][:] = np.arange(n, dtype=np.float32)
    w["value"][:] = np.arange(3 * n, dtype=np.float32).reshape(n, 3)
    w["index"][:] = np.arange(4 * n, dtype=np.int32).reshape(n, 4)
    for a in w.values():
        a.flush()
    return path


def test_bin_pipeline_epoch_shuffle_and_determinism(tmp_path):
    """ShardedBinPipeline: every epoch is a permutation of the shard, windows
    are deterministic per (seed, epoch), and row integrity holds across the
    two-level shuffle."""
    d = _bin_dir(str(tmp_path / "bin"))
    p = ShardedBinPipeline(d, window_rows=256)
    seen = []
    for b in p.epoch_batches(64, seed=1, epoch=0):
        assert b["label"].shape == (64,)
        # rows stay intact through the shuffle (value row i == label*3+j)
        np.testing.assert_array_equal(b["value"][:, 0], b["label"] * 3)
        np.testing.assert_array_equal(b["index"][:, 1],
                                      (b["label"] * 4 + 1).astype(np.int32))
        seen.append(b["label"])
    allseen = np.concatenate(seen)
    assert len(np.unique(allseen)) == len(allseen) == 960  # drop_remainder
    again = np.concatenate(
        [b["label"] for b in p.epoch_batches(64, seed=1, epoch=0)])
    np.testing.assert_array_equal(allseen, again)
    other = np.concatenate(
        [b["label"] for b in p.epoch_batches(64, seed=1, epoch=1)])
    assert not np.array_equal(allseen, other)

    # full coverage without drop_remainder
    full = np.concatenate([b["label"] for b in p.epoch_batches(
        64, seed=1, epoch=0, drop_remainder=False)])
    assert sorted(full.tolist()) == list(range(1000))

    # host sharding: two processes see disjoint halves
    p0 = ShardedBinPipeline(d, window_rows=256, process_index=0, process_count=2)
    p1 = ShardedBinPipeline(d, window_rows=256, process_index=1, process_count=2)
    r0 = np.concatenate([b["label"] for b in p0.epoch_batches(
        50, seed=1, epoch=0, drop_remainder=False)])
    r1 = np.concatenate([b["label"] for b in p1.epoch_batches(
        50, seed=1, epoch=0, drop_remainder=False)])
    assert len(np.intersect1d(r0, r1)) == 0
    assert len(r0) + len(r1) == 1000


@pytest.mark.parametrize("drop_remainder", [True, False])
def test_bin_batches_equal_the_jax_pipeline(tmp_path, drop_remainder):
    d = _bin_dir(str(tmp_path / "bin"))
    for h in range(3):
        got = ShardedBinPipeline(d, window_rows=128, process_index=h, process_count=3)
        want = J.ShardedBinPipeline(d, window_rows=128, process_index=h, process_count=3)
        a_all = list(got.epoch_batches(48, seed=5, epoch=2, drop_remainder=drop_remainder))
        b_all = list(want.epoch_batches(48, seed=5, epoch=2, drop_remainder=drop_remainder))
        assert len(a_all) == len(b_all) > 0
        for a, b in zip(a_all, b_all):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
