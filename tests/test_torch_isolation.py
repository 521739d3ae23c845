"""The PyTorch port stands alone: importing every module of
`alphafold2_tpu_torch` loads neither JAX, ml_dtypes nor any module of the
JAX package, `chip_smoke.py` imports none of them, and the entry points
(inference and training) refuse to run quietly on the CPU of a host
without CUDA."""

import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import alphafold2_tpu_torch
from alphafold2_tpu_torch import Alphafold2Config, alphafold2_apply, alphafold2_init
from alphafold2_tpu_torch import predict_structure
from alphafold2_tpu_torch.device import resolve_device

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import alphafold2_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m == "ml_dtypes"
             or m == "alphafold2_tpu" or m.startswith("alphafold2_tpu."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_every_module_imports_without_jax_or_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO_ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    import json

    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "alphafold2_tpu_torch.ops.flash_kernel" in res["modules"]
    assert "alphafold2_tpu_torch.predict" in res["modules"]
    for name in ("train_pre", "training.harness", "training.losses", "training.data",
                 "utils.flops", "telemetry.profiling", "ops.dispatch", "ops.quant",
                 "ops.quant_kernel", "ops.sparse", "ops.sparse_kernel",
                 "serving.quant_residency", "parallel", "parallel.mesh",
                 "parallel.sequence", "parallel.sp_trunk", "serve", "serving.engine",
                 "serving.executable", "serving.bucketing", "serving.cache", "serving.errors",
                 "serving.metrics", "reliability.breaker", "telemetry.registry",
                 "training.checkpoint", "training.resilience", "reliability.faults",
                 "reliability.preemption", "models.embedder", "models.refiner",
                 "training.e2e", "geometry.masks", "geometry.dihedral", "geometry.kabsch",
                 "geometry.metrics", "geometry.sidechain", "refinement", "refine",
                 "runtime", "runtime.native", "training.segmented", "serving.fleet",
                 "serving.admission", "serving.frontdoor", "serving.featurize",
                 "serving.journal", "serving.artifact_store", "serving.cascade",
                 "reliability.health", "reliability.retry_budget", "telemetry.ops_plane",
                 "serving.sp_arm", "serving.autoscale", "parallel.distributed",
                 "parallel.rules", "parallel.sharding", "parallel.train"):
        assert f"alphafold2_tpu_torch.{name}" in res["modules"]
    assert res["bad"] == []


def _imported_roots(path):
    tree = ast.parse(open(path).read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module)
    return roots


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    roots = _imported_roots(os.path.join(REPO_ROOT, "chip_smoke.py"))
    assert any(r.startswith("alphafold2_tpu_torch") for r in roots)
    for r in roots:
        top = r.split(".")[0]
        assert top not in ("jax", "jaxlib", "ml_dtypes", "alphafold2_tpu"), r


def test_port_sources_import_neither():
    pkg_dir = os.path.dirname(alphafold2_tpu_torch.__file__)
    mods = [m.name for m in pkgutil.walk_packages([pkg_dir])]
    assert mods
    for dirpath, _, files in os.walk(pkg_dir):
        for f in files:
            if f.endswith(".py"):
                for r in _imported_roots(os.path.join(dirpath, f)):
                    assert r.split(".")[0] not in ("jax", "jaxlib", "ml_dtypes",
                                                   "alphafold2_tpu"), (f, r)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda_instead_of_running_on_cpu(no_cuda):
    cfg = Alphafold2Config(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=16)
    params = alphafold2_init(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = np.zeros((1, 6), np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        predict_structure(params, cfg, tokens, mds_iters=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        alphafold2_apply(params, cfg, tokens)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        alphafold2_init(cfg, torch.Generator().manual_seed(0), None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    # the explicit CPU request runs
    out = predict_structure(params, cfg, tokens, mds_iters=2, device="cpu")
    assert out["coords"].device.type == "cpu"


def test_the_fleet_raises_without_cuda(no_cuda):
    """The fleet serves on the card unless asked for the CPU: without
    `device` it refuses before building a replica."""
    from alphafold2_tpu_torch.serving.engine import ServingConfig
    from alphafold2_tpu_torch.serving.fleet import FleetConfig, ServingFleet

    cfg = Alphafold2Config(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingFleet({}, cfg, ServingConfig(buckets=(8,)), FleetConfig(replicas=2))


def test_training_entry_points_raise_without_cuda(no_cuda):
    from alphafold2_tpu_torch import train_pre
    from alphafold2_tpu_torch.training import data, harness

    cfg = Alphafold2Config(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=16)
    tcfg = harness.TrainConfig(grad_accum=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        harness.train_state_init(cfg, tcfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        harness.make_train_step(cfg, tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_pre.main(["--steps", "1", "--dim", "16", "--heads", "2", "--dim-head", "8"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_pre.main(["--steps", "1", "--dim", "16", "--heads", "2", "--dim-head", "8",
                        "--data", "native", "--len-buckets", "64,128", "--len", "128"])
    state = harness.train_state_init(cfg, tcfg, torch.Generator().manual_seed(0), "cpu")
    batch = data.synthetic_microbatch_fn(data.DataConfig(max_len=8), 1)(0)
    mb = {k: v[0] for k, v in batch.items()}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        harness.distogram_loss_fn(state["params"], cfg, mb)
    # the explicit CPU request runs
    _, metrics = harness.make_train_step(cfg, tcfg, device="cpu")(state, batch)
    assert metrics["loss"].device.type == "cpu"


def test_profiling_needs_a_card_and_sorts_kernels(no_cuda):
    from alphafold2_tpu_torch.telemetry import profiling

    with pytest.raises(SystemExit, match="CUDA device"):
        profiling.main(["--length", "8"])
    assert profiling.kernel_kind("void flash_fwd_bf16_mma_kernel<64, false, false>") \
        .startswith("flash forward")
    assert profiling.kernel_kind("void flash_bwd_dkv_bf16_kernel<64, false>") \
        .startswith("flash backward")
    assert profiling.kernel_kind(
        "void at::native::multi_tensor_apply_kernel<at::native::TensorListMetadata<4>>") \
        .startswith("optimizer")
    with pytest.raises(SystemExit, match="CUDA device"):
        profiling.main(["--train", "--length", "8"])
    assert profiling.kernel_kind("sm90_xmma_gemm_bf16bf16_bf16f32").startswith("matrix")
    assert profiling.kernel_kind("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT").startswith("matrix")
    assert profiling.kernel_kind("void at::native::reduce_kernel<512, 1>").startswith("other")
    assert profiling.kernel_kind("void sparse_fwd_bf16_kernel<64, 16>").startswith("sparse forward")
    for name in ("void (anonymous namespace)::sparse_fwd_wgmma_kernel<3>(CUtensorMap)",
                 "(anonymous namespace)::sparse_fwd_ring_kernel(const __nv_bfloat16 *)"):
        assert profiling.kernel_kind(name).startswith("sparse forward")
    with pytest.raises(SystemExit, match="CUDA device"):
        profiling.main(["--train", "--sparse", "--length", "8"])
    assert profiling.kernel_kind("void sparse_dkv_bf16_kernel<64, 16>").startswith("sparse backward")
    assert profiling.kernel_kind("quant_matmul_bf16_kernel").startswith("int8")
    with pytest.raises(SystemExit):
        profiling.main(["--train", "--int8"])
    with pytest.raises(SystemExit):
        profiling.main(["--train", "--sp-shards", "4"])
    with pytest.raises(SystemExit, match="CUDA device"):
        profiling.main(["--sp-shards", "4", "--length", "8"])


def test_params_on_another_device_are_refused():
    cfg = Alphafold2Config(dim=16, depth=1, heads=2, dim_head=8, max_seq_len=16)
    params = alphafold2_init(cfg, torch.Generator().manual_seed(0), "cpu")
    params["head_out"]["w"] = params["head_out"]["w"].to("meta")
    with pytest.raises(ValueError, match="parameters lie on"):
        alphafold2_apply(params, cfg, np.zeros((1, 4), np.int32), device="cpu")


def test_full_atom_entry_points_raise_without_cuda(no_cuda, tmp_path):
    """`predict --full-atom`, the end-to-end forward and the embedder and
    refiner inits refuse to run quietly on the CPU; with --device cpu /
    device="cpu" they run."""
    from alphafold2_tpu_torch.models import embedder, refiner
    from alphafold2_tpu_torch.predict import main
    from alphafold2_tpu_torch.training import e2e

    gen = torch.Generator().manual_seed(0)
    args = ["--seq", "MKTAYIAKQR", "--full-atom", "--dim", "16", "--depth", "1", "--heads",
            "2", "--dim-head", "8", "--mds-iters", "2", "--out", str(tmp_path / "f.pdb")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        embedder.embedder_init(embedder.EmbedderConfig(num_layers=1, dim=16, heads=2), gen,
                               None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        refiner.refiner_init(refiner.RefinerConfig(), gen, None)
    ecfg = e2e.E2EConfig(model=Alphafold2Config(dim=16, depth=1, heads=2, dim_head=8,
                                                max_seq_len=32), mds_iters=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        e2e.e2e_params_init(ecfg, gen, None)
    params = e2e.e2e_params_init(ecfg, gen, "cpu")
    tokens = np.zeros((1, 6), np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        e2e.predict_structure(params, ecfg, tokens)
    # the explicit CPU requests run
    with torch.inference_mode():
        out = e2e.predict_structure(params, ecfg, tokens, device="cpu")
    assert out["refined"].shape == (1, 6, 14, 3)
    main(args + ["--device", "cpu"])
    assert (tmp_path / "f.pdb").exists()


def test_relaxation_entry_points_raise_without_cuda(no_cuda, tmp_path):
    """`refine`, `relax` on an array and `run_fast_relax` refuse to run
    quietly on the CPU; with --device cpu / device="cpu" they run."""
    from alphafold2_tpu_torch.geometry.pdb import coords_to_pdb
    from alphafold2_tpu_torch.refine import main
    from alphafold2_tpu_torch.refinement import relax, run_fast_relax

    coords = np.random.RandomState(0).randn(18, 3).astype(np.float32) * 3
    src, out = str(tmp_path / "in.pdb"), str(tmp_path / "out.pdb")
    coords_to_pdb(src, coords, sequence="AAAAAA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([src, out, "--iters", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        relax(coords, iters=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_fast_relax(coords, "AAAAAA", iters=2)
    main([src, out, "--iters", "2", "--device", "cpu"])
    assert os.path.exists(out)
