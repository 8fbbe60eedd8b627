"""The window-attention kernels' launch plan and the backward's split of dbias.

On the card the backward runs per (head, chunk of windows): each block sums
its head's dbias over its windows into a slab of its own, and a second
launch adds the slabs in a fixed order; no atomics.  Here, on the CPU:

* ``launch_plan`` at the shipped estimator's six window-attention shapes,
  at the eval forward's batch (B=32, fp32) and a training microbatch's
  (B=8, bf16), with and without the mask: every block's shared memory fits
  (232,448 bytes), the grids cover every window and head once (the fp32
  row kernel at hd >= 8 in whole rounds of four windows), a forward
  block's head group reads whole 32-byte sectors of q, k and v in fp32 (two
  heads of hd 4) and half sectors in bf16 (two heads of hd 4: four heads,
  whole sectors, measured slower on the card), the backward's grid fills
  the 132 SMs once at B=8 and has one dbias slab per chunk;
* the plain split (``window_attention_backward_split_reference``): its dqkv
  is the reference's bit for bit; its dbias too where one slab sums every
  window (no reduction), and within 1e-5 of max(1, largest |value|) for the
  plan's chunks (fp32 summation order only: the reference sums over all
  windows at once);
* the kernel source calls no atomic; the breakdown tool's copies apply;
  the kernel names the SASS counters read parse.

The ``gpu`` tests hold the library to this plan and check on the card what
only the card shows: the backward's bits run to run, tensor-core
instructions in every bf16 kernel and none in the fp32 ones, and no atomic
instruction in the backward's machine code:
  python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_window_attention_plan.py
"""

import re

import numpy as np
import pytest
import torch

from dmhomo_torch.ops import window_attention as wa

N = 64
# (H, W, C, heads): the Swin levels of the shipped estimator
LEVELS = [(160, 288, 24, 3), (80, 144, 48, 12), (40, 72, 96, 24), (80, 144, 48, 3),
          (40, 72, 96, 3), (40, 72, 96, 12)]
RUNS = [(32, torch.float32), (8, torch.bfloat16)]  # the eval forward, a training microbatch


def _level_inputs(level, B, dtype, masked):
    H, W, C, heads = level
    nW = (H // 8) * (W // 8)
    qkv = torch.empty((B * nW, N, 3 * C), dtype=dtype)
    return qkv, heads, (torch.zeros(nW, N, N) if masked else None)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("B, dtype", RUNS, ids=["eval-fp32", "step-bf16"])
@pytest.mark.parametrize("level", LEVELS, ids=[f"{h}x{w}c{c}h{n}" for h, w, c, n in LEVELS])
def test_launch_plan_at_shipped_shapes(level, B, dtype, masked):
    qkv, heads, mask = _level_inputs(level, B, dtype, masked)
    Bn, hd = qkv.shape[0], level[2] // heads
    n_mask = mask.shape[0] if masked else 1
    n_per = Bn // n_mask
    p = wa.launch_plan(qkv, heads, mask=mask)
    assert 0 < p["smem"] <= wa.SMEM_PER_BLOCK and p["blocks_per_sm"] >= 1
    assert p["partials"] == 0
    hg, per = p["heads_per_block"], p["windows_per_block"]
    groups = p["grid"][1]
    assert groups * hg >= heads > (groups - 1) * hg
    chunks = p["grid"][0] // n_mask
    assert p["grid"][0] == n_mask * chunks and chunks * per >= n_per > (chunks - 1) * per
    assert 1 <= per <= wa.FWD_MAX_WINDOWS
    # whole sectors of q, k and v in fp32, half ones in bf16
    assert hg * hd * qkv.element_size() % (32 if dtype == torch.float32 else 16) == 0
    if hd == 4:
        assert hg == 2
    if dtype == torch.float32 and hd >= 8:  # the row kernel: rounds of ROW_GROUPS windows
        assert p["threads"] == wa.ROW_GROUPS * N and per % wa.ROW_GROUPS == 0
    else:  # warp tiles: four warps a head, two heads at a time
        assert p["threads"] == (2 if hg > 1 else 1) * wa.TEAM
    if B != 8:
        return
    b = wa.launch_plan(qkv, heads, backward=True, mask=mask)
    assert 0 < b["smem"] <= wa.SMEM_PER_BLOCK and b["blocks_per_sm"] >= 1
    h, chunks = b["grid"]
    per = b["windows_per_block"]
    assert h == heads and b["heads_per_block"] == 1 and b["threads"] == wa.TEAM
    assert chunks * per >= Bn > (chunks - 1) * per
    # the grid fills the card's 132 SMs, and fits its slots once
    assert wa.SMS <= heads * chunks <= wa.SMS * b["blocks_per_sm"]
    assert b["partials"] == chunks and chunks > 1


@pytest.mark.parametrize("Bn, heads", [(1, 3), (5, 400), (45, 24)])
def test_backward_plan_small_grids(Bn, heads):
    """Fewer windows than slots: a window per block; one chunk (no
    reduction launch) when the heads alone fill the card."""
    b = wa.launch_plan(torch.empty(Bn, N, 3 * 4 * heads), heads, backward=True)
    h, chunks = b["grid"]
    assert chunks * b["windows_per_block"] >= Bn > (chunks - 1) * b["windows_per_block"]
    if heads >= wa.SMS * b["blocks_per_sm"]:
        assert chunks == 1 and b["partials"] == 1


def test_launch_plan_is_cached_by_shape():
    a = wa.launch_plan(torch.empty(360, N, 288), 24, backward=True)
    assert a is wa.launch_plan(torch.empty(360, N, 288), 24, backward=True)
    assert a is not wa.launch_plan(torch.empty(360, N, 288, dtype=torch.bfloat16), 24,
                                   backward=True)


def _split_inputs(dtype, Bn=12, nW=4, C=24, heads=3, masked=True, seed=0):
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.normal(0, 1, (Bn, N, 3 * C)).astype(np.float32)).to(dtype)
    bias = torch.from_numpy(rng.normal(0, 0.5, (heads, N, N)).astype(np.float32))
    gout = torch.from_numpy(rng.normal(0, 1, (Bn, N, C)).astype(np.float32)).to(dtype)
    mask = None
    if masked:
        mask = torch.zeros(nW, N, N)
        mask[torch.from_numpy(rng.uniform(size=(nW, N, N)) < 0.3)] = -100.0
    return qkv, bias, mask, gout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_split_backward_matches_reference(masked, dtype):
    """The split backward with one slab over every window (12 windows: the
    reference's sum then adds them in window order too) is the reference bit
    for bit; over the plan's chunks of 1, 5 and 12 windows, dbias within
    fp32 summation order."""
    args = _split_inputs(dtype, masked=masked)
    want_dqkv, want_dbias = wa.window_attention_backward_reference(*args, num_heads=3)
    dqkv, dbias = wa.window_attention_backward_split_reference(*args, num_heads=3,
                                                               windows_per_block=12)
    assert dqkv.dtype == dtype and dbias.dtype == torch.float32
    assert torch.equal(dqkv, want_dqkv)
    assert torch.equal(dbias, want_dbias)
    scale = max(1.0, float(want_dbias.abs().max()))
    for per in (1, 5):
        dqkv, dbias = wa.window_attention_backward_split_reference(*args, num_heads=3,
                                                                   windows_per_block=per)
        assert torch.equal(dqkv, want_dqkv)
        assert float((dbias - want_dbias).abs().max()) <= 1e-5 * scale, per


def test_dbias_partials_and_their_order():
    """Slab c sums windows c*per .. in order; the reduction sums four
    contiguous ranges of slabs, then the ranges, in order."""
    rng = np.random.default_rng(3)
    dsim = torch.from_numpy(rng.normal(0, 1, (11, 2, N, N)).astype(np.float32))
    parts = wa.dbias_partials_reference(dsim, 3)
    assert parts.shape == (4, 2, N, N)
    assert torch.equal(parts[3], (torch.zeros(2, N, N) + dsim[9]) + dsim[10])
    assert torch.equal(parts[1], ((torch.zeros(2, N, N) + dsim[3]) + dsim[4]) + dsim[5])
    slabs = torch.from_numpy(rng.normal(0, 1, (10, 2, N, N)).astype(np.float32))
    ranges = [slabs[0:3], slabs[3:6], slabs[6:9], slabs[9:10]]
    sums = []
    for r in ranges:
        acc = torch.zeros(2, N, N)
        for x in r:
            acc = acc + x
        sums.append(acc)
    want = ((sums[0] + sums[1]) + sums[2]) + sums[3]
    assert torch.equal(wa.reduce_dbias_partials(slabs), want)
    assert torch.equal(wa.reduce_dbias_partials(slabs[:1]), slabs[0])


def test_window_attention_source_calls_no_atomic():
    """No atomic function or PTX atom/red instruction anywhere in the
    window-attention kernels' source (on the card, the built machine code
    is searched too)."""
    code = re.sub(r"//[^\n]*", "", wa._SOURCE.read_text())  # comments may speak of atomics
    assert "window_attention_dbias_kernel" in code
    assert not re.findall(r"\batomic[A-Z]\w*\s*\(|\b(?:atom|red)\.(?:global|shared|add)", code)


def test_breakdown_edits_apply():
    """Each part the breakdown tool removes is found in the source."""
    from dmhomo_torch.ops import window_attention_breakdown as bd

    src = wa._SOURCE.read_text()
    copies = bd.variants(src)
    assert copies.pop("unchanged") == src
    assert len(copies) == 5 and all(text != src for text in copies.values())


@pytest.mark.parametrize("name, key", [
    ("_ZN12_GLOBAL__N_127window_attention_fwd_kernelI13__nv_bfloat16Li4ELb1EEEvPKT_PKfS6_PS3_iiiiif",
     ("fwd", "bfloat16", 4, True)),
    ("_ZN12_GLOBAL__N_127window_attention_fwd_kernelIfLi32ELb0EEEvPKT_PKfS5_PS2_iiiiif",
     ("fwd", "float32", 32, False)),
    ("_ZN12_GLOBAL__N_127window_attention_bwd_kernelIfLi16EEEvPKT_PKfS5_S4_PS2_Pfiiiiff",
     ("bwd", "float32", 16, None)),
    ("_ZN12_GLOBAL__N_132window_attention_fwd_rows_kernelILi8ELb1EEEvPKfS2_S2_Pfiiiif",
     ("fwd", "float32", 8, True)),
    ("_ZN12_GLOBAL__N_129window_attention_dbias_kernelEPfii", None),
])
def test_kernel_key(name, key):
    assert wa.kernel_key(name) == key


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; chip_smoke.py runs these checks there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_plan_matches_library(cuda_device, dtype, backward):
    """The library launches with the plan's numbers, at every shipped shape
    (B=8 and 32, +-mask) and at the small test shapes."""
    cases = [_level_inputs(level, B, dtype, masked) for level in LEVELS for B in (8, 32)
             for masked in (False, True)]
    cases += [(torch.empty(Bn, N, 3 * hd * 3, dtype=dtype), 3,
               torch.zeros(nW, N, N) if nW else None)
              for hd in wa.HEAD_DIMS for Bn, nW in ((4, 0), (180, 45), (45, 45))]
    for qkv, heads, mask in cases:
        want = wa.launch_plan(qkv, heads, backward, mask)
        got = wa.library_plan(qkv, heads, backward, mask)
        assert got == want, (tuple(qkv.shape), heads, mask is not None)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_window_backward_is_deterministic(cuda_device, dtype):
    """Two runs of the backward give the same dqkv and dbias bits, at a
    shape with many dbias slabs (the reduction launch runs)."""
    qkv, bias, mask, gout = (t if t is None else t.to(cuda_device) for t in
                             _split_inputs(getattr(torch, dtype), Bn=8 * 45, nW=45, C=96,
                                           heads=24))
    assert wa.library_plan(qkv, 24, True, mask)["partials"] > 1
    first = wa.window_attention_backward(qkv, bias, mask, gout, num_heads=24)
    second = wa.window_attention_backward(qkv, bias, mask, gout, num_heads=24)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32),
                           b.view(torch.int16 if b.dtype == torch.bfloat16 else torch.int32))


@pytest.mark.gpu
def test_cuda_tensor_cores(cuda_device):
    """HMMA in every bf16 kernel, forward and backward; none in the fp32 ones."""
    found = wa.tensor_core_instructions()
    assert len(found) == 2 * 4 * 2 + 2 * 4  # fwd: dtype x hd x mask; bwd: dtype x hd
    for (direction, dtype, hd, mask), n in found.items():
        if dtype == "bfloat16":
            assert n > 0, (direction, hd, mask)
        else:
            assert n == 0, (direction, hd, mask)


@pytest.mark.gpu
def test_cuda_backward_has_no_atomics(cuda_device):
    """No atomic instruction in the backward's instantiations and its
    reduction, nor in the forward's."""
    found = wa.atomic_instructions_by_kernel()
    assert sum("_bwd_" in n for n in found) == 2 * 4  # dtype x hd
    assert sum("_dbias_" in n for n in found) == 1
    assert sum("_fwd_" in n for n in found) == 2 * 4 * 2  # dtype x hd x mask
    assert sum(found.values()) == 0, found
