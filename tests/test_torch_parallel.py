"""The port's parallel layer against the JAX package's, on the CPU, in one
process (the two-process tests are ``test_torch_data_parallel.py``).

* ``shard_batch`` gives each rank the rows JAX's sharding puts on its
  device: the global batch split into the step's microbatches (JAX's
  ``accum`` rule, ``accum_for``) and laid out by
  ``stacked_batch_sharding`` over ``make_mesh(jax.devices()[:R])``, read
  back from ``addressable_shards``; exactly, over a grid of batch sizes,
  ``grad_accum`` and R in {2, 4}.
* ``bucket_sums`` / ``merge_bucket_sums`` equal JAX's (float32 sums,
  float64 merge: exactly).
* ``maybe_initialize_distributed`` does nothing without torchrun's
  environment or arguments; the grid refuses a ``model`` axis that does
  not divide the world size and places each rank where JAX's
  ``reshape(data, model)`` places its device (the grid under a 4-rank
  group: ``test_torch_shard_params.py``).
* ``hem_train`` and ``dgm_train`` under ``torchrun`` with 2 ranks on the
  CPU (``gloo``): both ranks report the same global losses, one checkpoint
  file (and for ``dgm_train`` one milestone preview) is written.
"""

import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dmhomo_tpu.evaluation.metrics import bucket_by_category as jax_bucket_by_category
from dmhomo_tpu.evaluation.metrics import bucket_sums as jax_bucket_sums
from dmhomo_tpu.evaluation.metrics import merge_bucket_sums as jax_merge_bucket_sums
from dmhomo_tpu.parallel import batch_sharding, make_mesh, stacked_batch_sharding

from dmhomo_torch.evaluation.metrics import (
    TEST_CATEGORIES,
    bucket_by_category,
    bucket_sums,
    category_report,
    merge_bucket_sums,
)
from dmhomo_torch.parallel import distributed
from dmhomo_torch.parallel.distributed import maybe_initialize_distributed, rank_and_world
from dmhomo_torch.parallel.mesh import (
    accum_for,
    make_mesh as port_make_mesh,
    mesh_coords,
    shard_batch,
    shard_stacked_batch,
)


def _jax_accum(B, data, grad_accum):
    """The JAX HEM trainer's microbatch count (``train/hem_trainer.py``,
    ``_step_body``), for a global batch B over ``data`` devices."""
    per_dev = max(B // max(data, 1), 1)
    accum = min(grad_accum, per_dev)
    while accum > 1 and (per_dev % accum or B % accum):
        accum -= 1
    return accum


def _device_rows(x, sharding, axis):
    """Each device's block of ``x`` as JAX places it, in mesh order."""
    arr = jax.device_put(x, sharding)
    shards = sorted(arr.addressable_shards, key=lambda s: s.index[axis].start or 0)
    return [np.asarray(s.data) for s in shards]


@pytest.mark.parametrize("R", [2, 4])
@pytest.mark.parametrize("grad_accum", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("B", [4, 8, 12, 16, 32])
def test_shard_batch_gives_each_rank_its_jax_rows(B, grad_accum, R):
    mesh = make_mesh(jax.devices()[:R])
    accum = _jax_accum(B, R, grad_accum)
    assert accum_for(B // R, R, grad_accum) == accum
    x = np.arange(B * 3, dtype=np.float32).reshape(B, 3)  # each row names itself
    if (B // accum) % R:  # the microbatch does not shard over the mesh: JAX cannot either
        with pytest.raises(ValueError):
            jax.device_put(x.reshape(accum, B // accum, 3), stacked_batch_sharding(mesh))
        with pytest.raises(ValueError):
            shard_batch(x, 0, R, accum)
        return
    # the step's view: (accum, mb, ...) with the microbatch axis over 'data'
    want = _device_rows(x.reshape(accum, B // accum, 3), stacked_batch_sharding(mesh), 1)
    for r in range(R):
        got = shard_batch({"x": x, "t": torch.from_numpy(x)}, r, R, accum)
        np.testing.assert_array_equal(got["x"], want[r].reshape(-1, 3))
        np.testing.assert_array_equal(got["t"].numpy(), want[r].reshape(-1, 3))
    if accum == 1:  # one microbatch: the plain batch sharding's contiguous blocks
        for r, rows in enumerate(_device_rows(x, batch_sharding(mesh), 0)):
            np.testing.assert_array_equal(shard_batch(x, r, R), rows)


@pytest.mark.parametrize("R", [2, 4])
def test_shard_stacked_batch_matches_jax(R):
    """(K, B, ...) stacks: axis 1 as JAX's ``stacked_batch_sharding``."""
    mesh = make_mesh(jax.devices()[:R])
    x = np.arange(3 * 8 * 2, dtype=np.float32).reshape(3, 8, 2)
    for r, rows in enumerate(_device_rows(x, stacked_batch_sharding(mesh), 1)):
        np.testing.assert_array_equal(shard_stacked_batch(x, r, R), rows)
    # with microbatches: each step's batch as shard_batch takes it
    for r in range(R):
        got = shard_stacked_batch(x, r, R, accum=2)
        for k in range(3):
            np.testing.assert_array_equal(got[k], shard_batch(x[k], r, R, accum=2))


def test_accum_for_on_one_card_is_the_old_rule():
    """World 1: min(grad_accum, B), stepped down until it divides B."""
    for B in range(1, 40):
        for g in range(1, 9):
            old = min(g, B)
            while old > 1 and B % old:
                old -= 1
            assert accum_for(B, 1, g) == old


def _errors_and_names(n, seed):
    rng = np.random.default_rng(seed)
    ids = [i for cat in TEST_CATEGORIES.values() for i in cat] + ["not-a-test-video"]
    return rng.uniform(0, 20, n).tolist(), [ids[i] for i in rng.integers(0, len(ids), n)]


def test_bucket_sums_and_merge_match_jax():
    """Per-rank sums of a split evaluation merge into JAX's buckets, and
    their report is the unsplit one's."""
    errs, names = _errors_and_names(60, 0)
    parts = [(errs[r::3], names[r::3]) for r in range(3)]
    got = [bucket_sums(bucket_by_category(e, n)) for e, n in parts]
    want = [jax_bucket_sums(jax_bucket_by_category(e, n)) for e, n in parts]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    merged = merge_bucket_sums(np.stack(got))
    assert merged == jax_merge_bucket_sums(np.stack(want))
    # already summed over the ranks (the all-reduce's result) merges alike
    assert merge_bucket_sums(np.stack(got).astype(np.float64).sum(0)) == merged
    whole = category_report(bucket_by_category(errs, names))
    for k, v in category_report(merged).items():
        assert v == pytest.approx(whole[k], rel=1e-6), k


def test_maybe_initialize_distributed_is_a_no_op_without_a_launcher(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert maybe_initialize_distributed() is False
    assert maybe_initialize_distributed(device="cpu") is False
    assert not distributed.is_distributed()
    assert rank_and_world() == (0, 1) and distributed.is_main_process()
    assert port_make_mesh().shape == {"data": 1, "model": 1}


@pytest.mark.parametrize("data,model", [(4, 2), (2, 4), (8, 1), (1, 8)])
def test_make_mesh_model_axis(data, model):
    """Without a group the world is one rank: a model axis above 1 does
    not divide it, nor does a data axis above 1 fill it.  Each rank's
    coordinates are its device's in the JAX mesh over 8 devices."""
    if model > 1:
        with pytest.raises(ValueError, match="does not divide"):
            port_make_mesh(model=model)
    if data > 1:
        with pytest.raises(ValueError, match="rank"):
            port_make_mesh(data, model=1)
    assert port_make_mesh().shape == {"data": 1, "model": 1}
    devices = jax.devices()[:data * model]
    jmesh = make_mesh(devices, data=data, model=model)
    for r, dev in enumerate(devices):
        want = tuple(int(i) for i in np.argwhere(jmesh.devices == dev)[0])
        assert mesh_coords(r, model) == want, r


def _torchrun(args, cwd):
    """``torchrun --standalone --nproc_per_node 2 -m <args>`` on the CPU;
    killed after 240 s."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([root, os.environ.get("PYTHONPATH", "")])}
    run = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc_per_node", "2", "-m", *args], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=240)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    return run.stdout + run.stderr


def test_hem_train_under_torchrun(tmp_path):
    out = tmp_path / "hem"
    log = _torchrun(["dmhomo_torch.cli.hem_train", "--synthetic", "16", "--tiny", "--steps", "2",
                     "--device", "cpu", "--out", str(out)], tmp_path)
    losses = re.findall(r"step 2/2 .*total:(\S+)", log)
    assert len(losses) == 2 and losses[0] == losses[1]  # every rank logs the global loss
    assert os.listdir(out) == ["model_latest.pth"]
    assert torch.load(out / "model_latest.pth", weights_only=True)["step"] == 2


def test_dgm_train_under_torchrun(tmp_path):
    out = tmp_path / "dgm"
    _torchrun(["dmhomo_torch.cli.dgm_train", "--synthetic", "8", "--dim", "8", "--dim-mults",
               "1,2", "--image-size", "16", "--batch-size", "4", "--accum", "2", "--steps", "2",
               "--save-every", "2", "--device", "cpu", "--results", str(out)], tmp_path)
    # one checkpoint and, at the milestone, one preview: rank 0 writes both
    assert sorted(os.listdir(out)) == ["model-2.pt", "previews"]
    assert os.listdir(out / "previews") == ["sample-2.png"]
    assert torch.load(out / "model-2.pt", weights_only=False)["step"] == 2
