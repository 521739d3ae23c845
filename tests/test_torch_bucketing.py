"""Length bucketing on the port (alphafold2_tpu_torch/training/data.py
`bucket_batches`, `bucketed_microbatches`; `train_pre --data native
--len-buckets`) against the JAX package's on the same item stream, on the
CPU: bit for bit (the same numpy draws and copies)."""

import argparse

import numpy as np
import pytest
import torch

from alphafold2_tpu.training import data as jdata
from alphafold2_tpu_torch import train_pre
from alphafold2_tpu_torch.runtime import NativePrefetchLoader
from alphafold2_tpu_torch.training import data as tdata
from alphafold2_tpu_torch.training import harness

BUCKETS = (16, 32, 48)


def items(n=40, seed=0):
    rs = np.random.RandomState(seed)
    for _ in range(n):
        L = rs.randint(5, 70)
        yield rs.randint(0, 20, L).astype(np.int32), rs.randn(L, 14, 3).astype(np.float32)


def assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == "bucket":
            assert a[k] == b[k] and isinstance(a[k], int)
        else:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("full_atom", [False, True])
@pytest.mark.parametrize("batch_size", [1, 3])
def test_bucket_batches_match_jax(full_atom, batch_size):
    kw = dict(batch_size=batch_size, max_len=BUCKETS[-1], seed=4)
    ours = list(tdata.bucket_batches(items(), tdata.DataConfig(**kw), BUCKETS, full_atom))
    theirs = list(jdata.bucket_batches(items(), jdata.DataConfig(**kw), BUCKETS, full_atom))
    assert len(ours) == len(theirs) > 0
    assert len({b["bucket"] for b in ours}) == len(BUCKETS)
    for a, b in zip(ours, theirs):
        assert_same(a, b)


def test_bucket_batches_needs_a_bucket():
    with pytest.raises(ValueError, match="at least one bucket"):
        next(tdata.bucket_batches(items(), tdata.DataConfig(), ()))


@pytest.mark.parametrize("accum", [1, 2, 3])
def test_bucketed_microbatches_match_jax(accum):
    cfg = dict(batch_size=2, max_len=BUCKETS[-1], seed=1)
    ours = list(tdata.bucketed_microbatches(
        tdata.bucket_batches(items(80), tdata.DataConfig(**cfg), BUCKETS), accum))
    theirs = list(jdata.bucketed_microbatches(
        jdata.bucket_batches(items(80), jdata.DataConfig(**cfg), BUCKETS), accum))
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert_same(a, b)
        assert a["seq"].shape == (accum, 2, a["bucket"])


def test_exported_from_training():
    from alphafold2_tpu_torch import training

    assert training.bucket_batches is tdata.bucket_batches
    assert training.bucketed_microbatches is tdata.bucketed_microbatches


TINY = ["--dim", "16", "--depth", "1", "--heads", "2", "--dim-head", "8", "--device", "cpu"]


class OneWorkerLoader(NativePrefetchLoader):
    """The CLI's loader with one worker: a fixed batch order, so a short
    run is known to reach both buckets (the pool draws L from [32, 4 len),
    so the small bucket takes about one protein in nine)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **dict(kwargs, n_threads=1))


def test_train_pre_native_buckets_reach_the_step(monkeypatch, capsys):
    """`train_pre --data native --len-buckets 56,64 --len 64` on the CPU:
    finite losses, and stacks of both bucket shapes, with no "bucket" key,
    reach the eager step (a bucket under 33 gets no protein of the pool)."""
    seen = []
    plain = train_pre.make_train_step
    monkeypatch.setattr(train_pre, "NativePrefetchLoader", OneWorkerLoader)

    def recording(*args, **kwargs):
        step = plain(*args, **kwargs)

        def wrapped(state, batch, rng=None):
            seen.append((tuple(batch.keys()), tuple(np.shape(batch["seq"]))))
            return step(state, batch, rng)

        return wrapped

    monkeypatch.setattr(train_pre, "make_train_step", recording)
    state, metrics = train_pre.main(TINY + ["--data", "native", "--len-buckets", "56,64",
                                            "--len", "64", "--steps", "12", "--accum", "2"])
    out = capsys.readouterr().out
    assert "length buckets: (56, 64)" in out and "native prefetch loader: C++" in out
    assert "done" in out and state["step"] == 12
    assert np.isfinite(float(metrics["loss"]))
    losses = [float(x.split()[3]) for x in out.splitlines() if x.startswith("step ")]
    assert losses and all(np.isfinite(losses))
    assert all("bucket" not in keys for keys, _ in seen)
    assert {shape for _, shape in seen} == {(2, 1, 56), (2, 1, 64)}


def test_train_pre_native_without_buckets(capsys):
    state, metrics = train_pre.main(TINY + ["--data", "native", "--len", "16", "--steps", "2",
                                            "--accum", "2"])
    assert state["step"] == 2 and np.isfinite(float(metrics["loss"]))
    assert "length buckets" not in capsys.readouterr().out


def test_train_pre_refuses_a_top_bucket_other_than_len():
    with pytest.raises(SystemExit, match=r"largest bucket \(32\) must equal --len \(64\)"):
        train_pre.main(TINY + ["--data", "native", "--len-buckets", "16,32", "--len", "64",
                               "--steps", "1"])


def test_train_pre_native_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_pre.main(TINY[:-2] + ["--data", "native", "--len-buckets", "16,32", "--len",
                                    "32", "--steps", "1"])


@pytest.mark.parametrize("buckets", ["", "48,64"])
def test_native_stream_closes_its_loader(monkeypatch, buckets):
    """The stream's loader (its C++ workers and queue) is closed when the
    stream is closed, after a few stacks."""
    loaders = []

    class Recording(NativePrefetchLoader):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            loaders.append(self)

    monkeypatch.setattr(train_pre, "NativePrefetchLoader", Recording)
    args = argparse.Namespace(len_buckets=buckets, max_len=64, batch=1)
    stream = train_pre.native_stream(args, tdata.DataConfig(batch_size=1, max_len=64),
                                     harness.TrainConfig(grad_accum=2))
    for _ in range(3):
        stack = next(stream)
        assert "bucket" not in stack and stack["seq"].shape[:2] == (2, 1)
    assert len(loaders) == 1 and not loaders[0]._closed
    stream.close()
    assert loaders[0]._closed and loaders[0]._handle is None
