"""Joining a pod and training data-parallel over it, the port on the CPU
(`alphafold2_tpu_torch/parallel/distributed.py`, `training/data.py`'s
per-process rows, `parallel/train.py make_multihost_train_step` through
train_pre's pod path), against the JAX package where it has the same
function.

- The launch contract: nothing joins without a coordinator or at one
  process; AF2_AUTO_INIT=1 joins from a launcher's env:// variables; a
  process id outside the pod, NCCL ranks that would share a card, and a
  default group of another world size are refused.
- `process_shard`, `shard_items` and `per_process_microbatch_fn` give the
  JAX package's arrays bit for bit.
- Two processes of `train_pre --device cpu` launched the JAX way
  (AF2_COORDINATOR / AF2_NUM_PROCESSES / AF2_PROCESS_ID, gloo) at tiny
  widths, 2 steps, against one process on the same global batches: the
  losses within 1e-5 relative, the two ranks' states byte-identical, no
  JAX module in the workers. One module-scoped launch serves every test
  that reads it, and `communicate(timeout=...)` fails a hang.
- The JAX CLIs' pod refusals, condition for condition, in both trainers.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from alphafold2_tpu.training import data as jdata
from alphafold2_tpu_torch import train_end2end, train_pre
from alphafold2_tpu_torch.parallel import data_parallel_mesh, distributed, make_mesh
from alphafold2_tpu_torch.parallel.distributed import (
    cpu_pod_env,
    distributed_startup,
    free_local_port,
    initialize_from_env,
    process_local_batch_size,
)
from alphafold2_tpu_torch.training import data as tdata

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POD_TIMEOUT = 180

TINY = ["--steps", "2", "--dim", "16", "--depth", "1", "--heads", "2", "--dim-head", "8",
        "--len", "12", "--accum", "2", "--batch", "2", "--device", "cpu"]

_WORKER = """
import hashlib, json, sys
import torch
from alphafold2_tpu_torch import train_pre
log = sys.argv[1]
state, metrics = train_pre.main(sys.argv[2:] + ["--metrics-log", log])
digests = [hashlib.sha256(t.detach().reshape(-1).contiguous().view(torch.uint8).numpy()
                         .tobytes()).hexdigest() for t in state["optimizer"].state_tensors()]
jax = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "alphafold2_tpu.")))
print(json.dumps({"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                  "step": state["step"], "digests": digests, "jax": jax}))
"""


def _launch(tmp, name, env):
    log = os.path.join(tmp, f"{name}.jsonl")
    proc = subprocess.Popen([sys.executable, "-c", _WORKER, log, *TINY], cwd=REPO_ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, log


@pytest.fixture(scope="module")
def pod_runs(tmp_path_factory):
    """Two gloo ranks of train_pre and the single-process run, all at once:
    {name: (its JSON line, its metrics log's lines, its stdout)}."""
    tmp = str(tmp_path_factory.mktemp("pod"))
    coordinator = f"127.0.0.1:{free_local_port()}"
    runs = {f"rank{r}": _launch(tmp, f"rank{r}", cpu_pod_env(
        coordinator=coordinator, num_processes=2, process_id=r, repo_path=REPO_ROOT))
        for r in range(2)}
    runs["single"] = _launch(tmp, "single", cpu_pod_env(repo_path=REPO_ROOT))
    out = {}
    try:
        for name, (proc, log) in runs.items():
            stdout, stderr = proc.communicate(timeout=POD_TIMEOUT)
            assert proc.returncode == 0, f"{name}: {stderr[-3000:]}"
            with open(log) as fh:
                lines = [json.loads(x) for x in fh if x.strip()]
            out[name] = (json.loads(stdout.strip().splitlines()[-1]), lines, stdout)
    finally:
        for proc, _ in runs.values():
            proc.kill()
    return out


def test_pod_trains_on_its_rows_as_one_process_does(pod_runs):
    """Each rank joins (the startup line), trains eager on its row of the
    global batch, and after 2 steps both ranks hold byte-identical states;
    every step's loss and grad_norm, and the last step's at full
    precision, within 1e-5 relative of the single-process run."""
    single, single_log, _ = pod_runs["single"]
    for r in range(2):
        got, log, stdout = pod_runs[f"rank{r}"]
        assert f"train_pre: joined multi-host runtime: process {r}/2" in stdout
        assert "data-parallel over 2 processes" in stdout
        assert got["step"] == 2 and got["jax"] == []
        assert got["loss"] == pytest.approx(single["loss"], rel=1e-5)
        assert got["grad_norm"] == pytest.approx(single["grad_norm"], rel=1e-5)
        for a, b in zip(log, single_log, strict=True):
            assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
            assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-5)
    assert pod_runs["rank0"][0]["digests"] == pod_runs["rank1"][0]["digests"]
    assert "joined" not in pod_runs["single"][2]


# --- the launch contract ------------------------------------------------------------


@pytest.fixture
def clean_env(monkeypatch):
    for var in ("AF2_COORDINATOR", "AF2_NUM_PROCESSES", "AF2_PROCESS_ID", "AF2_AUTO_INIT",
                "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    yield monkeypatch
    if dist.is_initialized():
        dist.destroy_process_group()


def test_no_pod_is_a_no_op(clean_env, capsys):
    """No coordinator, or one process: nothing is joined, nothing printed,
    the world is one process."""
    assert initialize_from_env() is False
    clean_env.setenv("AF2_COORDINATOR", "127.0.0.1:1")
    clean_env.setenv("AF2_NUM_PROCESSES", "1")
    clean_env.setenv("AF2_PROCESS_ID", "0")
    assert distributed_startup("train_pre") is False
    assert capsys.readouterr().out == ""
    assert (distributed.process_index(), distributed.process_count()) == (0, 1)
    assert process_local_batch_size(4) == 4


def test_auto_init_joins_from_the_launchers_variables(clean_env, capsys):
    """AF2_AUTO_INIT=1 joins from RANK / WORLD_SIZE / MASTER_ADDR /
    MASTER_PORT (env://), gloo on the CPU, and the startup line names the
    process; a second call with the same world is taken as joined, one
    asking for another world is refused."""
    clean_env.setenv("AF2_AUTO_INIT", "1")
    for var, val in (("RANK", "0"), ("WORLD_SIZE", "1"), ("MASTER_ADDR", "127.0.0.1"),
                     ("MASTER_PORT", str(free_local_port()))):
        clean_env.setenv(var, val)
    assert distributed_startup("train_pre", device="cpu") is True
    assert "train_pre: joined multi-host runtime: process 0/1" in capsys.readouterr().out
    assert dist.get_backend() == "gloo" and distributed.process_count() == 1
    assert initialize_from_env(device="cpu") is True
    with pytest.raises(RuntimeError, match="already exists"):
        initialize_from_env(coordinator="127.0.0.1:1", num_processes=2, process_id=0,
                            device="cpu")


def test_refusals(clean_env):
    """A process id outside the pod, and NCCL ranks that would share a card
    (two local ranks on a one-card host), are refused before any group
    forms; a pod's mesh must cover every process."""
    with pytest.raises(ValueError, match="outside a pod of 2"):
        initialize_from_env(coordinator="127.0.0.1:1", num_processes=2, process_id=2,
                            device="cpu")
    clean_env.setattr(torch.cuda, "is_available", lambda: True)
    clean_env.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="NCCL runs one rank a card"):
        initialize_from_env(coordinator="127.0.0.1:1", num_processes=2, process_id=1)
    assert not dist.is_initialized()
    clean_env.undo()
    clean_env.setattr(distributed, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="2-process run"):
        make_mesh({"data": 4})
    clean_env.undo()
    mesh = data_parallel_mesh(local=True)
    assert mesh.shape == {"data": len(mesh.devices)} and mesh.axis_name == "data"


# --- the per-process rows, bit for bit JAX's -------------------------------------------


def test_process_rows_match_jax():
    """process_shard (plain and microbatched axes), shard_items and
    per_process_microbatch_fn (distogram and structure sources) give the
    JAX package's arrays bit for bit (the structure source's clouds, which
    the port draws to 1e-6 of JAX's, at that tolerance), and this process's
    rows of the port's own global batch bit for bit; a batch that does not
    divide raises."""
    batch = next(tdata.synthetic_batches(tdata.DataConfig(batch_size=4, max_len=8, seed=2)))
    for index in range(2):
        got = tdata.process_shard(batch, index=index, count=2)
        want = jdata.process_shard(batch, index=index, count=2)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    stack = tdata.synthetic_microbatch_fn(tdata.DataConfig(batch_size=4, max_len=8), 2)(0)
    got = tdata.process_shard(stack, index=1, count=4, axis=1)
    want = jdata.process_shard(stack, index=1, count=4, axis=1)
    assert all(np.array_equal(got[k], want[k]) for k in got) and got["seq"].shape == (2, 1, 8)
    with pytest.raises(ValueError, match="must divide"):
        tdata.process_shard(batch, index=0, count=3)
    assert list(tdata.shard_items(range(10), index=1, count=3)) == list(
        jdata.shard_items(range(10), index=1, count=3))
    for source, jsource in ((None, None), (tdata.synthetic_structure_batches,
                                           jdata.synthetic_structure_batches)):
        for index in range(2):
            got = tdata.per_process_microbatch_fn(
                tdata.DataConfig(batch_size=2, max_len=8, msa_rows=2, seed=3), 2, source=source,
                index=index, count=2)(5)
            want = jdata.per_process_microbatch_fn(
                jdata.DataConfig(batch_size=2, max_len=8, msa_rows=2, seed=3), 2, source=jsource,
                index=index, count=2)(5)
            assert got.keys() == want.keys()
            whole = tdata.synthetic_microbatch_fn(
                tdata.DataConfig(batch_size=2, max_len=8, msa_rows=2, seed=3), 2,
                source=source)(5)
            for k in got:
                # this process's rows of the port's own global batch, bit for bit
                np.testing.assert_array_equal(got[k], whole[k][:, index:index + 1])
                if source is not None and k == "coords":
                    # the structure source's clouds are JAX's to 1e-6
                    # (tests/test_torch_e2e_train.py test_structure_batches_match_jax)
                    np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
                else:
                    np.testing.assert_array_equal(got[k], want[k])
    rows = tdata.assemble_global_batch(stack, make_mesh({"data": 1}, devices=["cpu"]))
    assert (rows.start, rows.total) == (0, 4) and torch.equal(rows["seq"],
                                                              torch.as_tensor(stack["seq"]))


# --- the JAX CLIs' pod refusals ---------------------------------------------------------


PRE = dict(sp_shards=0, data="synthetic", fault_plan=None, batch=2, ckpt_dir=None,
           ckpt_verify=False)
PRE_REFUSED = {
    "sp_shards": (dict(sp_shards=2), "--sp-shards is the single-process grid-sharding path"),
    "data": (dict(data="native"), "--data native has no per-process sharding contract"),
    "fault_plan": (dict(fault_plan="plan.json"), "--fault-plan is single-process chaos"),
    "batch": (dict(batch=3), "--batch 3 is the GLOBAL batch and must divide"),
    "ckpt_verify": (dict(ckpt_dir="ck"), "add --ckpt-verify"),
    "ckpt": (dict(ckpt_dir="ck", ckpt_verify=True), "A13-ckpt"),
}
E2E = dict(PRE, trunk_segments=0, features="msa", profile_dir=None)
E2E_REFUSED = {
    "sp_shards": (dict(sp_shards=2), "--sp-shards shards the grid single-process"),
    "trunk_segments": (dict(trunk_segments=2), "--trunk-segments is a single-device"),
    "esm": (dict(features="esm"), "multi-host training runs --data synthetic"),
    "fault_plan": (dict(fault_plan="plan.json"), "--fault-plan is single-process chaos"),
    "batch": (dict(batch=3), "--batch 3 is the GLOBAL batch and must divide"),
    "ckpt_verify": (dict(ckpt_dir="ck"), "add --ckpt-verify"),
    "profile_dir": (dict(profile_dir="prof"), "--profile-dir is single-process tooling"),
    "ckpt": (dict(ckpt_dir="ck", ckpt_verify=True), "A13-ckpt"),
}


@pytest.mark.parametrize("cli, base, case", [("train_pre", PRE, c) for c in PRE_REFUSED]
                         + [("train_end2end", E2E, c) for c in E2E_REFUSED])
def test_cli_pod_refusals(cli, base, case):
    """Each JAX CLI's refusal under a pod, in its order, with its words;
    the port's own (multi-process checkpoints, A13-ckpt) after them; a
    clean pod run is not refused."""
    module = train_pre if cli == "train_pre" else train_end2end
    table = PRE_REFUSED if cli == "train_pre" else E2E_REFUSED
    fields, words = table[case]
    with pytest.raises(SystemExit, match=words.replace("-", "\\-").replace(".", "\\.")):
        module.refuse_in_pod(types.SimpleNamespace(**{**base, **fields}), 2)
    module.refuse_in_pod(types.SimpleNamespace(**base), 2)
