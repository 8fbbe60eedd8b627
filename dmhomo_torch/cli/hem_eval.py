"""HEM CAHomo evaluation on the card: per-category point-matching errors.

Examples:
  python -m dmhomo_torch.cli.hem_eval --test-data CAHomo --torch-ckpt HEM.pth
  python -m dmhomo_torch.cli.hem_eval --test-data CAHomo --ckpt experiments/hem/best

``--torch-ckpt`` takes a reference HEM .pth; ``--ckpt`` a checkpoint of the
port's own trainer (``hem_train --out DIR`` writes ``DIR/model_latest.pth``
and ``DIR/model_best.pth``): ``DIR/best``, ``DIR/latest`` or the file.

``--model-dir`` reads a reference ``params.json``; on the card any
configuration inside the kernels' envelope runs through hand-written
kernels: windows up to 12x12 that divide each level's resolution (a level
smaller than its window takes one window over the whole map, as the
reference does), widths C = heads x hd up to 384 with head dims up to 64,
MLPs up to 4 C.  The shipped 8x8 windows take the tuned kernels, every
other shape the generic ones (``ops/window_attention.py::variant``,
``ops/swin_block.py::variant``); a configuration outside the envelope
raises before any launch.

``--mask-vis DIR`` also writes the reference's per-category qualitative
dumps (``evaluation/mask_vis.py::mask_vis_categories``: JPEGs of each pair
and its mask heatmaps, a flip GIF) from the same forward's full-resolution
``flow_b``, ``mask_f`` and ``mask_b``, the per-category counts carried
across batches.

Runs on ``cuda`` (raises without a card) unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from dmhomo_torch.config import EstimatorConfig, Params
from dmhomo_torch.evaluation.metrics import (
    TEST_CATEGORIES,
    TEST_CATEGORIES_TESTFN,
    bucket_by_category,
    category_report,
    point_matching_error,
)
from dmhomo_torch.models.estimator import build_estimator, upsample_outputs


@torch.inference_mode()
def eval_forward(model, patch: torch.Tensor, pt_set: torch.Tensor, full_hw,
                 keep_outputs: bool = False):
    """One eval batch: estimator -> full-resolution view -> point errors (B,);
    with ``keep_outputs``, (errors, the full-resolution outputs)."""
    full = upsample_outputs(model(patch), full_hw)
    errors = point_matching_error(pt_set, full["flow_f"], full["flow_b"])
    return (errors, full) if keep_outputs else errors


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--test-data", type=str, required=True)
    parser.add_argument("--model-dir", type=str, default=None, help="dir with params.json")
    ckpt = parser.add_mutually_exclusive_group(required=True)
    ckpt.add_argument("--ckpt", type=str, default=None,
                      help="the port trainer's checkpoint: <out>/best, <out>/latest or the file")
    ckpt.add_argument("--torch-ckpt", type=str, default=None, help="reference HEM .pth")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--out-json", type=str, default=None)
    parser.add_argument("--seed-zero", action="store_true",
                        help="reproduce the reference's biased category lists")
    parser.add_argument("--category-set", choices=("eval", "test"), default="eval",
                        help="'eval' = hem_evaluate.py lists (default); 'test' = the "
                        "test() twin's lists ('0000030' under SF)")
    parser.add_argument("--mask-vis", type=str, default=None, metavar="DIR",
                        help="dump per-category qualitative panels/GIFs "
                        "(HEM/evaluate.py::mask_vis)")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from dmhomo_torch.data.hem_data import CAHomoTestDataset
    from dmhomo_torch.data.loader import iterate_batches, pad_batch
    from dmhomo_torch.models.convert import load_hem_checkpoint, load_reference_state_dict
    from dmhomo_torch.utils.checkpoint import resolve_checkpoint

    cfg = (EstimatorConfig.from_params(Params(os.path.join(args.model_dir, "params.json")))
           if args.model_dir else EstimatorConfig())
    model = build_estimator(cfg, device=args.device)
    path = resolve_checkpoint(args.ckpt) if args.ckpt else args.torch_ckpt
    load_reference_state_dict(model, load_hem_checkpoint(path))
    device = next(model.parameters()).device

    ds = CAHomoTestDataset(args.test_data, crop_size=cfg.crop_size)
    errs, names, vis_counts = [], [], {}
    for batch in iterate_batches(ds, args.batch_size):
        # one batch shape throughout: pad the tail, keep its valid rows
        batch, n_valid = pad_batch(batch, args.batch_size)
        e, full = eval_forward(model, torch.from_numpy(batch["imgs_gray_patch"]).to(device),
                               torch.from_numpy(batch["pt_set"]).to(device), cfg.ori_size,
                               keep_outputs=True)
        errs.extend(e.cpu().numpy()[:n_valid].tolist())
        names.extend(batch["video_names"][:n_valid])
        if args.mask_vis:
            from dmhomo_torch.evaluation.mask_vis import mask_vis_categories

            mask_vis_categories({k: v[:n_valid] for k, v in batch.items()},
                                {k: full[k][:n_valid].cpu().numpy()
                                 for k in ("flow_b", "mask_f", "mask_b")},
                                args.mask_vis, counts=vis_counts, device=device)

    cats = TEST_CATEGORIES_TESTFN if args.category_set == "test" else TEST_CATEGORIES
    report = category_report(
        bucket_by_category(errs, names, categories=cats, seed_zero=args.seed_zero))
    print(json.dumps(report))
    from dmhomo_torch.parallel.distributed import is_main_process

    if args.out_json and is_main_process():  # one writer under a process group
        with open(args.out_json, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
