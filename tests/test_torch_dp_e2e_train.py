"""The data-parallel step of the structure loss, port vs JAX package (CPU,
float32): the port's `parallel/train.py make_sharded_train_step(...,
loss_fn=e2e_loss_fn)` over two CPU shards against JAX's over {"data": 2}
of tests/conftest.py's virtual CPU mesh (tp=False), on the same weights
and batches of unequal lengths. Bounds: JAX's own e2e test's (loss 2e-5
relative, params 3e-5), with the classical MDS init and JAX's kabsch in
its eager form (tests/test_torch_e2e_train.py). The distogram loss and
dropout: tests/test_torch_dp_train.py.
"""

import jax
import numpy as np
import pytest
import torch

from alphafold2_tpu.training import data as jdata
from alphafold2_tpu.training import e2e as je2e
from alphafold2_tpu.parallel import train as jtrain
from alphafold2_tpu.training import harness as jharness
from alphafold2_tpu_torch.device import tree_leaves
from alphafold2_tpu_torch.models.convert import e2e_params_from_jax
from alphafold2_tpu_torch.parallel import make_sharded_train_step
from alphafold2_tpu_torch.training import e2e, harness
from test_torch_dp_train import jax_state, jmesh, tmesh
from test_torch_e2e_train import configs, eager_form_kabsch, params_pair


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's small tensors (the suite runs
    several workers on a few cores), restored after it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_dp_e2e_step_matches_jax(monkeypatch):
    """Two steps of the structure loss over 2 shards (b = 2, one structure
    a shard, the second padded to 6 of 8 residues) against JAX's sharded
    step: loss 2e-5 relative, params 3e-5. The step totals both terms'
    denominators over the shards (the structures, and the pairs of
    positive distogram weight: (3L)^2 a structure here, the mask does not
    censor them, so the shards' counts agree and the distogram test is
    the one whose counts differ)."""
    monkeypatch.setattr(je2e, "kabsch", eager_form_kabsch)
    jc, tc = configs(dict(depth=1), refiner=dict(num_tokens=14, dim=16, depth=1, msg_dim=16),
                     mds_iters=3)
    jp, tp = params_pair(jc, tc)
    jt = jharness.TrainConfig(learning_rate=1e-3, grad_accum=1)
    tt = harness.TrainConfig(learning_rate=1e-3, grad_accum=1)
    fetch = jdata.synthetic_microbatch_fn(jdata.DataConfig(batch_size=2, max_len=8, seed=0), 1,
                                          source=jdata.synthetic_structure_batches)
    jstep, _ = jtrain.make_sharded_train_step(
        jc, jt, jmesh(), fetch(0), loss_fn=je2e.e2e_loss_fn, tp=False, donate_state=False,
        state_init=je2e.e2e_train_state_init)
    tstep, _ = make_sharded_train_step(tc, tt, tmesh(), fetch(0), loss_fn=e2e.e2e_loss_fn,
                                       tp=False)
    jstate, tstate = jax_state(jp, jt), harness.train_state(tp, tt)
    for n in range(2):
        batch = dict(fetch(n))
        batch["mask"] = np.array(batch["mask"])
        batch["mask"][:, 1, 6:] = False
        jstate, jmet = jstep(jstate, batch, jax.random.PRNGKey(n))
        tstate, tmet = tstep(tstate, batch, torch.Generator().manual_seed(n))
        assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]), rel=2e-5)
    want = e2e_params_from_jax(jax.tree_util.tree_map(np.asarray, jstate["params"]), tc, "cpu")
    for w, leaf in zip(tree_leaves(want), tstate["optimizer"].leaves):
        torch.testing.assert_close(leaf.detach(), w, rtol=0, atol=3e-5)
