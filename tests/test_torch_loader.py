"""The port's ``DataLoader`` against the JAX package's: the same batches in
the same order for seeds, shards (2 of 3), 0 and 2 worker threads, with and
without prefetch, over two epochs; worker processes (in a fresh
interpreter); a worker's error raised on the consumer's side; an iteration
stopped early; pinned batches need a card
(``tests/test_torch_pipeline_gpu.py``)."""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from dmhomo_tpu.data import loader as jloader

from dmhomo_torch.data import loader as tloader

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dataset(n):
    return [{"x": np.full((2, 3), i, np.float32), "i": np.int64(i), "name": str(i)}
            for i in range(n)]


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x["name"] == y["name"]
        for k in ("x", "i"):
            np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("shard_index, num_shards", [(0, 1), (1, 3), (2, 3)])
@pytest.mark.parametrize("num_workers, prefetch", [(0, 2), (2, 2), (2, 0)])
def test_loader_matches_jax(seed, shard_index, num_shards, num_workers, prefetch):
    ds = _dataset(29)
    kw = dict(batch_size=4, seed=seed, shard_index=shard_index, num_shards=num_shards,
              num_workers=num_workers, prefetch=prefetch)
    ours, theirs = tloader.DataLoader(ds, **kw), jloader.DataLoader(ds, **kw)
    assert len(ours) == len(theirs) > 0
    for _ in range(2):  # two epochs: a new order each, the same on both sides
        _assert_same(list(ours), list(theirs))
    ours.close()
    theirs.close()


def test_loader_worker_processes_match_jax():
    """Worker processes, forked from a fresh interpreter without JAX (a fork
    of this process, whose JAX runs threads, could deadlock in the child):
    the JAX loader's batches over two epochs (its worker processes take the
    same indices as its threads)."""
    code = (
        "import json\n"
        "import numpy as np\n"
        "from dmhomo_torch.data.loader import DataLoader\n"
        "ds = [{'x': np.full((2, 3), i, np.float32), 'name': str(i)} for i in range(13)]\n"
        "dl = DataLoader(ds, 3, seed=1, shard_index=1, num_shards=2, num_workers=2,\n"
        "                use_processes=True, drop_last=False)\n"
        "print(json.dumps([[b['name'], b['x'].tolist()] for _ in range(2) for b in dl]))\n"
        "dl.close()\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    theirs = jloader.DataLoader(_dataset(13), 3, seed=1, shard_index=1, num_shards=2,
                                num_workers=2, drop_last=False)
    want = [[b["name"], b["x"].tolist()] for _ in range(2) for b in theirs]
    theirs.close()
    assert json.loads(proc.stdout.splitlines()[-1]) == want


class _Failing:
    def __len__(self):
        return 12

    def __getitem__(self, i):
        if i == 7:
            raise KeyError(f"sample {i}")
        return {"x": np.zeros(2)}


@pytest.mark.parametrize("num_workers, prefetch", [(0, 0), (0, 2), (2, 2)])
def test_worker_error_reaches_the_consumer(num_workers, prefetch):
    dl = tloader.DataLoader(_Failing(), 2, shuffle=False, num_workers=num_workers,
                            prefetch=prefetch)
    seen = []
    with pytest.raises(KeyError, match="sample 7"):
        for batch in dl:
            seen.append(batch)
    assert len(seen) == 3  # the batches before the one holding sample 7
    dl.close()


def test_stopping_early_ends_the_prefetch_thread():
    before = threading.active_count()
    dl = tloader.DataLoader(_dataset(40), 2, num_workers=2, prefetch=2)
    it = iter(dl)
    next(it)
    it.close()
    dl.close()
    assert threading.active_count() == before


def test_shard_index_is_checked():
    with pytest.raises(ValueError):
        tloader.DataLoader(_dataset(4), 2, shard_index=3, num_shards=3)
