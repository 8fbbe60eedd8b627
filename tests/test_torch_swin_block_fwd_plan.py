"""The whole-block Swin forward's launch plan, on the CPU.

On the card the forward is one launch, one block of 256 threads per 8x8
window (``ops/swin_block.py::forward_plan``): two window buffers, one for
q | k | v (by head groups at C = 96) and one C x C weight block in the I/O
dtype, plus an fp32 staging area for bf16.  Here:

* ``forward_plan`` at the six Swin-block shapes of the shipped estimator, in
  both dtypes, at the training microbatch (B=8) and the eval batch (B=32):
  shared memory fits one block (232,448 bytes, 227 KB), two blocks share an
  SM (three at C <= 48), bf16 at C = 96 too, the grid covers every window
  once, the head groups hold every head;
* the SASS counter that ``chip_smoke.py`` runs on the built library finds
  the tensor-core instructions in a listing, per function;
* the breakdown tool's forward edits still apply to the source.
"""

import pytest
import torch

from dmhomo_torch.ops import swin_block as sb
from dmhomo_torch.ops.build import count_tensor_core

# (H, W, C, heads) of the shipped estimator's Swin blocks
SHIPPED = [(160, 288, 24, 3), (80, 144, 48, 3), (40, 72, 96, 3), (80, 144, 48, 12),
           (40, 72, 96, 12), (40, 72, 96, 24)]


@pytest.mark.parametrize("B", [8, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHIPPED, ids=[f"{h}x{w}c{c}h{n}" for h, w, c, n in SHIPPED])
def test_forward_plan_at_shipped_shapes(shape, dtype, B):
    H, W, C, heads = shape
    plan = sb.forward_plan(torch.empty((B, H, W, C), dtype=dtype), heads, 3 * C)
    windows = B * (H // 8) * (W // 8)
    assert plan["windows"] == windows and plan["grid"] == (windows,)
    assert plan["threads"] == sb.THREADS
    assert 0 < plan["smem"] <= sb.SMEM_PER_BLOCK
    assert plan["blocks_per_sm"] >= (3 if C <= 48 else 2)
    if dtype == torch.bfloat16 and C == 96:
        assert plan["blocks_per_sm"] >= 2
    assert plan["head_groups"] == (3 if C == 96 else 1) and heads % plan["head_groups"] == 0
    # rows of a bf16 buffer: an odd number of 16-byte units (ldmatrix without conflicts)
    for ld in (plan["row_stride"], plan["qkv_row_stride"]):
        if dtype == torch.bfloat16:
            assert (2 * ld) % 16 == 0 and (2 * ld // 16) % 2 == 1
        else:
            assert ld % 8 == 4


def test_forward_plan_dtypes_differ_and_cache():
    x = torch.empty((8, 40, 72, 96), dtype=torch.bfloat16)
    a, b = sb.forward_plan(x, 24, 288), sb.forward_plan(x, 24, 288)
    c = sb.forward_plan(x.float(), 24, 288)
    assert a is b and a["smem"] < c["smem"]


_SASS = """\
\tFunction : _ZN12_GLOBAL__N_121swin_block_fwd_kernelI13__nv_bfloat16Li24ELi4EEEvPKT_
        /*0090*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*00a0*/              @P0  HMMA.1688.F32.BF16 R4, R8, R16, R4 ;
        /*00b0*/                   HGMMA.64x32x16.F32.BF16 R24, gdesc[UR4], R24 ;
        /*00c0*/                   FFMA R1, R2, R3, R4 ;
\tFunction : _ZN12_GLOBAL__N_121swin_block_fwd_kernelIfLi24ELi4EEEvPKT_
        /*0090*/                   FFMA R1, R2, R3, R4 ;
        /*00a0*/                   IMAD R5, R2, R3, R4 ;
\tFunction : _Z13other_kernelPf
        /*0090*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
"""


@pytest.mark.parametrize("name_part, want", [
    ("swin_block_fwd_kernel", {"13__nv_bfloat16": 3, "IfLi": 0}),
    ("other_kernel", {"other_kernel": 1}),
    ("absent", {}),
])
def test_count_tensor_core_in_sass(name_part, want):
    """HMMA and HGMMA count, predicated or not; FFMA and IMAD do not; other
    functions' lines go to their own entry."""
    got = count_tensor_core(_SASS, name_part)
    assert len(got) == len(want)
    for part, n in want.items():
        (name,) = [k for k in got if part in k]
        assert got[name] == n, name


def test_forward_breakdown_edits_apply():
    """Each part the breakdown tool removes from the forward is found in the
    source, so its copies differ from the source by that part."""
    from dmhomo_torch.ops import swin_block_breakdown as bd

    src = sb._SOURCE.read_text()
    copies = bd.forward_variants(src)
    assert copies.pop("unchanged") == src
    assert len(copies) == 5 and all(text != src for text in copies.values())
    assert len(set(copies.values())) == 5
