"""The port's native host runtime (alphafold2_tpu_torch/runtime/native.py
over its copy of csrc/af2_runtime.cc) against the JAX package's
(alphafold2_tpu/runtime/native.py) on the same datasets and seeds.

Bit for bit: the C++ loader at n_threads=1 (one worker, one generator: a
fixed batch order), plain and bucketed, at several batch sizes. At
n_threads=2 the workers' batches interleave in an order that varies from
run to run, so there the contract is checked: shapes, prefix masks, pads,
crops that are contiguous slices of a source protein.
"""

import os

import numpy as np
import pytest

import alphafold2_tpu.runtime.native as jnative
from alphafold2_tpu_torch.runtime import NativePrefetchLoader, native

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def dataset(n=12, seed=0, lo=6, hi=40):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        L = rs.randint(lo, hi)
        out.append((rs.randint(0, 20, L).astype(np.int32),
                    rs.randn(L, 14, 3).astype(np.float32)))
    return out


def snapshot(directory):
    """Each file's mtime, but the JAX package's own build output (its
    loader, in another test, may build it at any time)."""
    return {name: os.stat(os.path.join(directory, name)).st_mtime_ns
            for name in os.listdir(directory) if name != "libaf2runtime.so"}


def test_the_source_is_the_root_copy():
    with open(os.path.join(REPO_ROOT, "csrc", "af2_runtime.cc"), "rb") as a, \
            open(native.SRC, "rb") as b:
        assert a.read() == b.read()


def test_the_build_lands_in_build_runtime_and_not_in_csrc():
    csrc = os.path.join(REPO_ROOT, "csrc")
    before = snapshot(csrc)
    path = native.build()
    assert native._load() is not None
    assert path.parent == native.BUILD_DIR
    assert native.BUILD_DIR == native.Path(REPO_ROOT) / "build" / "runtime"
    assert path.name.startswith("libaf2runtime-") and path.exists()
    assert snapshot(csrc) == before
    assert not list(native.BUILD_DIR.glob("*.tmp"))


def test_a_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    broken = tmp_path / "af2_runtime.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "runtime")
    with pytest.raises(RuntimeError, match="(?s)building the native runtime failed.*error: expected"):
        native.build()
    assert not list((tmp_path / "runtime").glob("*"))


def batches_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == "bucket":
            assert a[k] == b[k]
        else:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("batch_size", [1, 2, 3])
@pytest.mark.parametrize("buckets", [None, (8, 16, 40)])
def test_one_thread_loader_matches_jax(buckets, batch_size):
    ds = dataset(n=30, seed=7)
    max_len = 40 if buckets else 16
    kw = dict(batch_size=batch_size, max_len=max_len, seed=3, n_threads=1, buckets=buckets)
    ours, theirs = NativePrefetchLoader(ds, **kw), jnative.NativePrefetchLoader(ds, **kw)
    assert theirs.native
    try:
        seen = set()
        for _ in range(12):
            a, b = ours.next(), theirs.next()
            batches_equal(a, b)
            seen.add(a["seq"].shape[1])
        assert len(seen) >= (2 if buckets else 1)
    finally:
        ours.close()
        theirs.close()


@pytest.mark.parametrize("buckets", [None, (16, 32, 64)])
def test_two_thread_contract(buckets):
    rs = np.random.RandomState(2)
    ds = dataset(n=20, seed=9, lo=6, hi=120)
    text = {i: "".join(map(chr, s + 65)) for i, (s, _) in enumerate(ds)}
    loader = NativePrefetchLoader(ds, batch_size=3, max_len=64, seed=int(rs.randint(99)),
                                  n_threads=2, buckets=buckets)
    try:
        for _ in range(20):
            b = loader.next()
            L = b["seq"].shape[1]
            assert L == (b["bucket"] if buckets else 64)
            if buckets:
                assert L in buckets
            assert b["seq"].dtype == np.int32 and b["mask"].dtype == bool
            assert b["coords"].shape == (3, L, 14, 3)
            for i in range(3):
                n = int(b["mask"][i].sum())
                assert n >= 6 and b["mask"][i, :n].all() and not b["mask"][i, n:].any()
                assert (b["seq"][i, n:] == 20).all() and (b["coords"][i, n:] == 0).all()
                row = "".join(map(chr, b["seq"][i, :n] + 65))
                src = [j for j, t in text.items() if row in t]
                assert src, "a row must be a contiguous crop of a source protein"
                j = src[0]
                start = text[j].find(row)
                np.testing.assert_array_equal(b["coords"][i, :n], ds[j][1][start:start + n])
    finally:
        loader.close()
    with pytest.raises(RuntimeError, match="closed"):
        loader.next()


def test_loader_refusals():
    with pytest.raises(ValueError, match="non-empty"):
        NativePrefetchLoader([], batch_size=1, max_len=8)
    with pytest.raises(ValueError, match="largest bucket"):
        NativePrefetchLoader(dataset(), batch_size=1, max_len=32, buckets=(8, 16))

