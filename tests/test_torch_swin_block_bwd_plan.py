"""The whole-block Swin backward's launch plan and its split of the work.

On the card the backward is five kernels (``ops/swin_block.py``'s
``BACKWARD_KERNELS``): the forward recomputed with the MLP's, LN2's and the
projection's backward per window; the attention's backward per head and
chunk of windows (dbias summed on chip); dx per window; the weight
gradients as products over token splits; one fixed-order sum of every
partial.  No global atomics.  Here, on the CPU:

* ``backward_plan`` at the six block shapes of a shipped training
  microbatch (B=8) x both dtypes x +-mask: every kernel's shared memory
  fits one block (232,448 bytes), the grids cover every window and token
  once, the scratch buffers are aligned and disjoint; the old per-window
  kernel's atomics, counted per launch, sum to 11.43 G per shipped step
  (within 1%);
* the kernel source calls no atomic (on the card, ``chip_smoke.py`` counts
  the atomic instructions in the built machine code), and the SASS
  counter that does so finds them in a listing;
* the plain versions of the split (``backward_window_reference`` and
  ``weight_gradients_reference``) compose to ``swin_block_backward_reference``
  bit for bit, in fp32 and bf16; summed in the plan's token ranges over
  window-ordered tokens, within 1e-5 of max(1, largest |value|) (fp32
  summation order only);
* the breakdown tool's edits still apply to the source.
"""

import re

import numpy as np
import pytest
import torch

from dmhomo_torch.ops import swin_block as sb
from dmhomo_torch.ops.build import count_atomics

from test_torch_swin_block import _inputs, _port_params, _rel_err

# (H, W, C, heads, backward launches per shipped training step): the Swin
# levels of the shipped estimator at B=8, four microbatches a step, h_net
# twice per forward (as chip_smoke.py's phase 20 counts them)
LEVELS = [(160, 288, 24, 3, 16), (80, 144, 48, 12, 32), (40, 72, 96, 24, 48),
          (80, 144, 48, 3, 16), (40, 72, 96, 3, 16), (40, 72, 96, 12, 32)]
OLD_ATOMICS_PER_STEP = 11.43e9  # the per-window kernel's count
TILE_TOKENS = 64


def _x(B, H, W, C, dtype):
    return torch.empty((B, H, W, C), dtype=dtype)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("level", LEVELS, ids=[f"{h}x{w}c{c}h{n}" for h, w, c, n, _ in LEVELS])
def test_backward_plan_at_shipped_shapes(level, dtype, masked):
    H, W, C, heads, _ = level
    x = _x(8, H, W, C, dtype)
    mask = torch.zeros((H // 8) * (W // 8), 64, 64) if masked else None
    plan = sb.backward_plan(x, heads, 3 * C, mask)
    windows = 8 * (H // 8) * (W // 8)
    assert plan["windows"] == windows and plan["tokens"] == 64 * windows
    k = plan["kernels"]
    assert list(k) == list(sb.BACKWARD_KERNELS)
    for name, kern in k.items():
        assert 0 <= kern["smem"] <= sb.SMEM_PER_BLOCK, name
        if name != "reduce":
            assert kern["blocks_per_sm"] >= 1, name
    assert k["recompute"]["grid"] == k["input"]["grid"] == (windows,)
    h, chunks = k["attention"]["grid"]
    per = k["attention"]["windows_per_block"]
    assert h == heads and chunks * per >= windows > (chunks - 1) * per
    # the attention's grid fills the card about once
    assert heads * chunks <= sb.SMS * sb.ATT_MAX_BLOCKS + heads
    splits, blocks = k["weights"]["grid"]
    span = k["weights"]["tokens_per_block"]
    assert blocks == 2 * 3 + 4 and span % TILE_TOKENS == 0
    assert splits * span >= plan["tokens"] > (splits - 1) * span
    end = 0
    for name in sb.SCRATCH:
        offset, nbytes = plan["scratch"][name]
        assert offset % 256 == 0 and offset >= end and nbytes > 0, name
        end = offset + nbytes
    assert plan["scratch_bytes"] >= end
    el = x.element_size()
    assert plan["scratch"]["qkv"][1] == plan["tokens"] * 3 * C * el
    assert plan["scratch"]["dm1"][1] == plan["tokens"] * 3 * C * 4
    assert plan["scratch"]["bpart"][1] == chunks * heads * 64 * 64 * 4
    assert plan["atomics"] == 0
    assert plan["atomics_old"] == windows * (10 * C * C + 12 * C + heads * 4096)


def test_backward_atomics_per_step():
    """The per-window kernel's global atomics per shipped step, and the new
    scheme's: at most a twentieth of them (none)."""
    old = new = 0
    for H, W, C, heads, launches in LEVELS:
        plan = sb.backward_plan(_x(8, H, W, C, torch.bfloat16), heads, 3 * C)
        old += launches * plan["atomics_old"]
        new += launches * plan["atomics"]
    assert sum(n for *_, n in LEVELS) == 160
    assert abs(old / OLD_ATOMICS_PER_STEP - 1) < 0.01
    assert new <= old / 20


@pytest.mark.parametrize("B, H, W, C, heads", [(1, 40, 72, 96, 24), (1, 40, 72, 48, 3),
                                                (3, 40, 72, 96, 12), (1, 8, 8, 24, 3)])
def test_backward_plan_small_grids(B, H, W, C, heads):
    """Fewer windows than SMs: one window per attention block, every window
    and token covered once; a window count that is no multiple of the
    windows per block leaves a short last chunk."""
    plan = sb.backward_plan(_x(B, H, W, C, torch.bfloat16), heads, 3 * C)
    windows = plan["windows"]
    h, chunks = plan["kernels"]["attention"]["grid"]
    per = plan["kernels"]["attention"]["windows_per_block"]
    assert chunks * per >= windows > (chunks - 1) * per
    if windows * heads <= sb.SMS:
        assert per == 1 and chunks == windows
    splits, _ = plan["kernels"]["weights"]["grid"]
    span = plan["kernels"]["weights"]["tokens_per_block"]
    assert span % TILE_TOKENS == 0 and splits * span >= plan["tokens"] > (splits - 1) * span


def test_backward_plan_is_cached_by_shape():
    a = sb.backward_plan(_x(8, 40, 72, 96, torch.bfloat16), 24, 288)
    b = sb.backward_plan(_x(8, 40, 72, 96, torch.bfloat16), 24, 288)
    c = sb.backward_plan(_x(8, 40, 72, 96, torch.float32), 24, 288)
    assert a is b and c["scratch_bytes"] > a["scratch_bytes"]


def test_swin_block_source_calls_no_atomic():
    """No atomic function or PTX atom/red instruction anywhere in the
    whole-block kernels' source."""
    src = sb._SOURCE.read_text()
    code = re.sub(r"//[^\n]*", "", src)  # comments may speak of atomics
    assert "swin_block_bwd_reduce_kernel" in code
    assert not re.findall(r"\batomic[A-Z]\w*\s*\(|\b(?:atom|red)\.(?:global|shared|add)", code)


_SASS = """\
\tFunction : _ZN12_GLOBAL__N_131swin_block_bwd_recompute_kernelIfLi24ELi4EEEvPKT_
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0090*/              @P0  RED.E.ADD.F32.FTZ.RN.STRONG.GPU [R2.64], R5 ;
        /*00a0*/                   ATOMG.E.ADD.F32.FTZ.RN.STRONG.GPU PT, RZ, [R2.64], R5 ;
        /*00b0*/                   REDUX.SUM UR4, R3 ;
        /*00c0*/             @!P1  ATOMS.ADD RZ, [R4], R5 ;
\tFunction : _Z13other_kernelPf
        /*0090*/                   RED.E.ADD.F32.FTZ.RN.STRONG.GPU [R2.64], R5 ;
\tFunction : _ZN12_GLOBAL__N_128swin_block_bwd_reduce_kernelENS_8SegmentsE
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   SHFL.BFLY PT, R3, R2, 0x10, 0x1f ;
"""


@pytest.mark.parametrize("name_part, want", [
    ("swin_block_bwd_", {"recompute": 3, "reduce": 0}),
    ("other_kernel", {"other_kernel": 1}),
    ("absent", {}),
])
def test_count_atomics_in_sass(name_part, want):
    """RED, ATOMG and ATOMS count, predicated or not; REDUX (a warp
    reduction) does not; other functions' lines go to their own entry."""
    got = count_atomics(_SASS, name_part)
    assert len(got) == len(want)
    for part, n in want.items():
        (name,) = [k for k in got if part in k]
        assert got[name] == n, name


def test_breakdown_edits_apply():
    """Each part the breakdown tool removes from the backward is found in
    the source, so its copies differ from the source by that part."""
    from dmhomo_torch.ops import swin_block_breakdown as bd

    src = sb._SOURCE.read_text()
    copies = bd.variants(src)
    assert copies.pop("unchanged") == src
    assert len(copies) == 8 and all(text != src for text in copies.values())


def _split_inputs(dtype, shift, B=1, H=16, W=24, C=24, heads=3, hidden=72):
    x, params, mask = _inputs(30 + shift, B, H, W, C, heads, hidden, shift)
    dy = np.random.default_rng(31 + shift).normal(0, 1, x.shape).astype(np.float32)
    return (torch.from_numpy(x).to(dtype), _port_params(params),
            None if mask is None else torch.from_numpy(mask), torch.from_numpy(dy).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift", [0, 4])
def test_split_plain_backward_composes_to_reference(shift, dtype):
    """Per-window part, then the weight-gradient product: the reference's
    dx and 13 gradients, bit for bit."""
    args = _split_inputs(dtype, shift)
    want_dx, want = sb.swin_block_backward_reference(*args, num_heads=3, shift=shift)
    dx, operands, grads = sb.backward_window_reference(*args, num_heads=3, shift=shift)
    assert set(operands) == {n for pair in sb.WEIGHT_PRODUCTS.values() for n in pair}
    assert operands["dm1"].dtype == operands["dh"].dtype == torch.float32
    assert all(operands[n].dtype == dtype for n in ("n1", "dqkv", "ao", "n2", "gm", "dy"))
    grads.update(sb.weight_gradients_reference(operands))
    assert sorted(grads) == sorted(sb.PARAM_NAMES)
    assert torch.equal(dx, want_dx)
    for name, w in zip(sb.PARAM_NAMES, want):
        assert torch.equal(grads[name], w), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_weight_gradients_in_token_ranges(dtype):
    """The product summed as the card sums it (window-ordered tokens, the
    ranges' partials added in order) against the reference's order."""
    args = _split_inputs(dtype, 4, B=2)
    _, operands, _ = sb.backward_window_reference(*args, num_heads=3, shift=4)
    whole = sb.weight_gradients_reference(operands)
    for span in (64, 192):
        split = sb.weight_gradients_reference(operands, split_tokens=span)
        for name, w in whole.items():
            assert _rel_err(split[name], w) <= 1e-5, (span, name)
