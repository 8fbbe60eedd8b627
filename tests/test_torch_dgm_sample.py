"""The generation entry point on the CPU: ``dgm_sample`` at a tiny size
(dim 8, 16x16, 2 DDIM steps) writes reference-format shards that
``load_generation_shard`` reads back, with homographies that reproduce the
condition flows (within 1e-3 px, fp32)."""

import numpy as np
import torch

from dmhomo_torch.cli import dgm_sample
from dmhomo_torch.data.conditions import synthetic_condition_batches
from dmhomo_torch.data.shards import load_generation_shard
from dmhomo_torch.geometry.homography import homography_to_flow


def test_dgm_sample_cli_on_cpu(tmp_path):
    args = ["--synthetic", "6", "--dim", "8", "--dim-mults", "1,2", "--image-size", "16",
            "--s-step", "2", "--bs", "2", "--batches", "3", "--batches-per-shard", "2",
            "--exp", "smoke", "--out", str(tmp_path), "--seed", "3", "--device", "cpu"]
    result = dgm_sample.main(args)
    assert result["samples"] == 6 and len(result["shards"]) == 2
    assert result["shards"][0].endswith("idx_0_rank_0_part_0_dm_cahomo_0.004k.npy")
    batches = [b for p in result["shards"] for b in load_generation_shard(p)]
    assert [b["imgs"].shape for b in batches] == [(2, 6, 16, 16)] * 3
    assert all(b["imgs"].dtype == np.uint8 for b in batches)
    # the same seeded condition draws: each batch's H gives back its flow
    conds = synthetic_condition_batches(6, 16, 2, 1, seed=3)
    for b in batches:
        cond, _ = next(conds)
        flow = homography_to_flow(torch.from_numpy(np.asarray(b["homos"])), 16, 16).numpy()
        np.testing.assert_allclose(flow, cond[..., 10:12], rtol=0, atol=1e-3)
    # the same weights and seed give the same shards
    again = dgm_sample.main(args[:-6] + ["--out", str(tmp_path / "again"), "--seed", "3",
                                         "--device", "cpu"])
    for p, q in zip(result["shards"], again["shards"]):
        for a, b in zip(load_generation_shard(p), load_generation_shard(q)):
            np.testing.assert_array_equal(a["imgs"], b["imgs"])
