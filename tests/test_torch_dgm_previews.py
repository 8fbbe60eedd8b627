"""``dgm_train --fuse-steps / --preview-every / --no-preview`` and
``dgm_sample --ckpt / --preview-every`` on the CPU, without JAX, at a tiny
size (dim 8, mults (1, 2), 16x16, batch 4 in 2 microbatches).

* ``--fuse-steps 3`` writes the checkpoints of step-by-step training, bit
  for bit (on the CPU a chunk is its steps one by one);
* previews land at the milestones ``--preview-every`` divides, as parsed
  PNGs of the held-out batch's panel grid; ``--no-preview`` writes none;
* ``dgm_sample --ckpt ROOT`` writes the shards of ``--torch-ckpt
  ROOT/model-<newest>.pt``, byte for byte; ``--preview-every 1`` writes a
  panel per batch; the two flags exclude each other.
"""

import os
import struct
import zlib

import pytest
import torch

from dmhomo_torch.cli import dgm_sample, dgm_train

TINY = ["--synthetic", "8", "--dim", "8", "--dim-mults", "1,2", "--image-size", "16",
        "--batch-size", "4", "--accum", "2", "--device", "cpu", "--no-bf16"]
SAMPLE = ["--synthetic", "8", "--dim", "8", "--dim-mults", "1,2", "--image-size", "16",
          "--s-step", "4", "--bs", "2", "--exp", "e", "--batches", "2", "--device", "cpu"]


def parse_png(data: bytes) -> dict:
    """The chunks of a PNG file: IHDR's fields and the inflated IDAT."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF, kind
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h, depth, colour = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    return {"w": w, "h": h, "depth": depth, "colour": colour,
            "idat": zlib.decompress(chunks[b"IDAT"]), "end": b"IEND" in chunks}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Four steps saved every 2, previews every 4, by chunks of 3."""
    root = tmp_path_factory.mktemp("train")
    results = str(root / "results")
    out = dgm_train.main(TINY + ["--steps", "4", "--save-every", "2", "--fuse-steps", "3",
                                 "--preview-every", "4", "--results", results])
    return results, out


def _ckpt(path):
    return torch.load(path, map_location="cpu", weights_only=False)


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def test_fuse_steps_writes_the_steps_checkpoints(trained, tmp_path):
    results, out = trained
    assert out["step"] == 4 and sorted(os.listdir(results)) == ["model-2.pt", "model-4.pt",
                                                                 "previews"]
    one = str(tmp_path / "one")
    dgm_train.main(TINY + ["--steps", "4", "--save-every", "2", "--preview-every", "4",
                           "--results", one])
    for step in (2, 4):
        assert _same(_ckpt(f"{results}/model-{step}.pt"), _ckpt(f"{one}/model-{step}.pt")), step


def test_previews_at_the_milestones(trained):
    results, _ = trained
    assert os.listdir(os.path.join(results, "previews")) == ["sample-4.png"]
    p = parse_png(open(os.path.join(results, "previews", "sample-4.png"), "rb").read())
    # the held-out batch: 4 conditions, a 2 x 2 grid of (2S, 4S) panels
    assert (p["w"], p["h"]) == (2 * (4 * 16 + 2) - 2, 2 * (2 * 16 + 2) - 2)
    assert len(p["idat"]) == p["h"] * (1 + 3 * p["w"])


def test_no_preview_and_every_milestone(tmp_path):
    none, every = str(tmp_path / "none"), str(tmp_path / "every")
    dgm_train.main(TINY + ["--steps", "2", "--save-every", "1", "--no-preview",
                           "--results", none])
    assert not os.path.exists(os.path.join(none, "previews"))
    dgm_train.main(TINY + ["--steps", "2", "--save-every", "1", "--fuse-steps", "2",
                           "--results", every])
    assert sorted(os.listdir(os.path.join(every, "previews"))) == ["sample-1.png",
                                                                  "sample-2.png"]


def test_dgm_sample_ckpt_root_equals_its_newest_file(trained, tmp_path):
    results, _ = trained
    a = dgm_sample.main(SAMPLE + ["--ckpt", results, "--out", str(tmp_path / "a"),
                                  "--preview-every", "1"])
    b = dgm_sample.main(SAMPLE + ["--torch-ckpt", os.path.join(results, "model-4.pt"),
                                  "--out", str(tmp_path / "b")])
    assert len(a["shards"]) == len(b["shards"]) == 1 and a["samples"] == 4
    for x, y in zip(a["shards"], b["shards"]):
        assert os.path.basename(x) == os.path.basename(y)
        assert open(x, "rb").read() == open(y, "rb").read()
    # random weights write other shards: the checkpoint was read
    c = dgm_sample.main(SAMPLE + ["--out", str(tmp_path / "c")])
    assert open(c["shards"][0], "rb").read() != open(a["shards"][0], "rb").read()
    names = sorted(os.path.basename(p) for p in a["previews"])
    assert names == ["shard_00_batch_00000.png", "shard_00_batch_00001.png"]
    for path in a["previews"]:
        p = parse_png(open(path, "rb").read())
        assert (p["w"], p["h"]) == (2 * (4 * 16 + 2) - 2, 2 * 16)
        assert len(p["idat"]) == p["h"] * (1 + 3 * p["w"])
    assert not os.path.exists(os.path.join(str(tmp_path / "b"), "e", "previews"))


def test_dgm_sample_ckpt_flags_exclude_each_other(tmp_path):
    with pytest.raises(SystemExit):
        dgm_sample.main(SAMPLE + ["--ckpt", "x", "--torch-ckpt", "y"])
    with pytest.raises(FileNotFoundError, match="model-"):
        dgm_sample.main(SAMPLE + ["--ckpt", str(tmp_path), "--out", str(tmp_path)])
