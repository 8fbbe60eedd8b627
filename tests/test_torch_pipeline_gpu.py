"""The data pipeline's streaming path without JAX or OpenCV (the card's
machine has neither).

On the CPU: ``hem_train --samples`` streams per-sample files through the
loader's worker threads, with the device or the host pipeline.  On the card
(``gpu`` marker, skipped here inside a fixture): conditions built on the card
against the CPU (images and rgb_flow 1e-5, the mask exact, the flow 1e-4
px); a pinned batch copied with ``non_blocking=True`` equal to the pageable
copy; ``train_steps`` fed pinned loader batches bit-identical to
``train_steps`` on the same batches from pageable numpy arrays, after 3 fp32
steps with deterministic algorithms (the shipped widths and window, cut
depth, 128x128 crops).
"""

import os

import numpy as np
import pytest
import torch

from dmhomo_torch.cli import make_conditions
from dmhomo_torch.data.conditions import build_conditions
from dmhomo_torch.data.hem_data import SyntheticHomoPairs
from dmhomo_torch.data.loader import DataLoader
from dmhomo_torch.data.shards import explode_shards_to_samples, save_generation_shard


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_samples(root, n: int, size: int, seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    homos = []
    for _ in range(n):
        d = rng.normal(0, 0.002, (3, 3))
        d[2, :2] *= 1e-3
        d[2, 2] = 0
        homos.append(np.eye(3) + d)
    shard = os.path.join(root, "shard.npy")
    save_generation_shard(shard, [{"imgs": rng.integers(0, 256, (n, 6, size, size), np.uint8),
                                   "homos": np.stack(homos)}])
    out = os.path.join(root, "samples")
    explode_shards_to_samples([shard], out)
    return out


@pytest.mark.parametrize("host_pipeline", [False, True])
def test_hem_train_streams_samples_on_cpu(tmp_path, host_pipeline):
    from dmhomo_torch.cli import hem_train
    from dmhomo_torch.utils.checkpoint import checkpoint_path

    samples = _write_samples(str(tmp_path), 16, 32)
    out = str(tmp_path / "hem")
    argv = ["--samples", samples, "--tiny", "--steps", "3", "--fuse-steps", "2", "--device",
            "cpu", "--out", out] + (["--host-pipeline"] if host_pipeline else [])
    tr = hem_train.main(argv)
    assert tr.step == 3 and os.path.exists(checkpoint_path(out, "latest"))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; chip_smoke.py phase 26 runs the pipeline there")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_conditions_match_cpu(cuda_device):
    raw = list(zip(*make_conditions.synthetic_raw_samples(6, (360, 640), seed=3)))[:4]
    card = build_conditions(*raw, device=cuda_device).cpu().numpy()
    cpu = build_conditions(*raw, device="cpu").numpy()
    assert card.shape == (6, 256, 256, 12)
    np.testing.assert_array_equal(card[..., 6:7], cpu[..., 6:7])
    for sl, tol in ((slice(0, 6), 1e-5), (slice(7, 10), 1e-5), (slice(10, 12), 1e-4)):
        np.testing.assert_allclose(card[..., sl], cpu[..., sl], rtol=0, atol=tol)


@pytest.mark.gpu
def test_cuda_pinned_copy_equals_pageable(cuda_device):
    ds = SyntheticHomoPairs(4, (64, 96), (72, 112), rho=3)
    pinned = next(iter(DataLoader(ds, 4, seed=1, pin_memory=True, num_workers=2)))
    pageable = next(iter(DataLoader(ds, 4, seed=1)))
    for k, v in pageable.items():
        assert pinned[k].is_pinned(), k
        copy = pinned[k].to(cuda_device, non_blocking=True)
        torch.cuda.synchronize()
        assert torch.equal(copy.cpu(), torch.from_numpy(v)), k
        assert torch.equal(copy, torch.from_numpy(v).to(cuda_device)), k


@pytest.fixture
def deterministic():
    was = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    yield
    torch.use_deterministic_algorithms(was[0])
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = was[1], was[2]


@pytest.mark.gpu
def test_cuda_pinned_batches_train_bit_identically(cuda_device, deterministic, tmp_path):
    """The same three raw-schema batches, once as the pinned loader hands
    them over (copied on the trainer's copy stream, each replay waiting on its
    event) and once as pageable numpy arrays (copied before any step): the
    same losses, weights and BatchNorm statistics, bit for bit."""
    from dmhomo_torch.config import EstimatorConfig, SwinConfig
    from dmhomo_torch.data.hem_data import HEMTrainDataset
    from dmhomo_torch.train.config import HEMTrainConfig
    from dmhomo_torch.train.hem_trainer import HEMTrainer

    swin = SwinConfig(crop_size=(128, 128), depths=(2, 1, 1))
    cfg = HEMTrainConfig(estimator=EstimatorConfig(ori_size=(144, 144), swin=swin), bf16=False,
                         train_batch_size=8)
    samples = _write_samples(str(tmp_path), 24, 96)
    ds = HEMTrainDataset(samples, (128, 128), (144, 144), rho=4, rng=np.random.default_rng(0))
    pinned = list(DataLoader(ds, 8, seed=2, num_workers=2, pin_memory=True))
    assert len(pinned) == 3 and all(v.is_pinned() for b in pinned for v in b.values())
    pageable = [{k: v.numpy().copy() for k, v in b.items()} for b in pinned]
    results = []
    for batches in (pinned, pageable):
        tr = HEMTrainer(cfg, device=cuda_device)
        tr.init_state(0)
        losses = tr.train_steps(batches)
        torch.cuda.synchronize()
        results.append((losses, tr.model.state_dict()))
    (got, got_sd), (want, want_sd) = results
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for k in want_sd:
        assert torch.equal(got_sd[k], want_sd[k]), k
