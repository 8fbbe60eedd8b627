"""The ranks' side of ``test_torch_data_parallel.py`` and
``test_torch_shard_params.py``: one process per rank, started by those
tests' module fixtures as

  python tests/torch_dp_ranks.py DIR RANK WORLD [shard]

It joins a ``gloo`` group on the CPU through ``DIR/pg`` (a file, so that
concurrent test workers never share a port), reads ``DIR/inputs.pt``, runs
every case on this rank's rows of each global batch, and writes what it
saw to ``DIR/rank<RANK>.pt``.  With ``shard`` it runs the DGM trainer with
``shard_params`` on a (WORLD / 2, 2) mesh instead.  It imports torch and
the port only, never JAX, so that it starts in seconds.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import torch
import torch.distributed as dist

from dmhomo_torch.cli.hem_train import tiny_config
from dmhomo_torch.diffusion.gaussian import DiffusionConfig
from dmhomo_torch.losses.hem_losses import nll_laplace
from dmhomo_torch.models.unet import UNetConfig
from dmhomo_torch.parallel.distributed import maybe_initialize_distributed
from dmhomo_torch.parallel.mesh import accum_for, make_mesh, shard_batch
from dmhomo_torch.train.config import DGMTrainConfig
from dmhomo_torch.train.dgm_trainer import DGMTrainer
from dmhomo_torch.train.hem_trainer import HEMTrainer

TIMEOUT_S = 60.0  # a collective that waits longer fails the rank


def hem_config(batch: int, grad_accum: int, model_dir: str = "unused"):
    """The tiny HEM config of ``test_torch_train.py``, fp32, no remat."""
    return dataclasses.replace(tiny_config(3, False, model_dir), bf16=False, remat=False,
                               grad_accum=grad_accum, train_batch_size=batch)


def dgm_config(batch: int, accum: int, lr: float, ema_every: int):
    """The tiny DGM config of ``test_torch_dgm_train.py``, fp32."""
    return DGMTrainConfig(
        unet=UNetConfig(dim=8, dim_mults=(1, 2), num_classes=2),
        diffusion=DiffusionConfig(image_size=16, timesteps=1000, sampling_timesteps=4),
        train_batch_size=batch, gradient_accumulate_every=accum, bf16=False, lr=lr,
        ema_update_every=ema_every, seed=0)


def hem_trainer(case: dict, model_dir: str = "unused") -> HEMTrainer:
    tr = HEMTrainer(hem_config(case["batch"], case["grad_accum"], model_dir),
                    steps_per_epoch=case["steps_per_epoch"], device="cpu")
    tr.init_state()
    tr.load_params(case["params"], case["stats"])
    return tr


def hem_steps(case: dict, rank: int, world: int) -> dict:
    """Steps on this rank's rows of each global batch: the loss terms of
    each step, the gradients of the first, the state after each."""
    tr = hem_trainer(case)
    accum = accum_for(case["batch"] // world, world, case["grad_accum"])
    out = {"accum": accum, "losses": [], "states": []}
    for k, batch in enumerate(case["batches"]):
        losses = tr.train_step(shard_batch(batch, rank, world, accum))
        out["losses"].append({n: float(v) for n, v in losses.items()})
        if k == 0:
            out["grads"] = {n: p.grad.clone() for n, p in tr.model.named_parameters()}
        out["states"].append({n: v.clone() for n, v in tr.model.state_dict().items()})
    out["lr"] = tr.lr
    return out


def dgm_step(case: dict, rank: int, world: int) -> dict:
    """One step on this rank's rows, the global microbatches' draws
    injected: the loss, the gradients before the clip, the clip, the
    weights and the EMA after."""
    tr = DGMTrainer(dgm_config(case["batch"], case["accum"], case["lr"], case["ema_every"]),
                    device="cpu")
    tr.init_state()
    tr.load_params(case["params"])
    img, cls = (shard_batch(x, rank, world, case["accum"]) for x in case["data"])
    loss = tr.loss_and_grads(img, cls, draws=case["draws"])
    grads = {n: p.grad.clone() for n, p in tr.model.named_parameters()}
    upd = tr.apply_gradients()
    return {"loss": float(loss), "grads": grads, "grad_norm": float(upd["grad_norm"]),
            "clip_scale": float(upd["clip_scale"]),
            "params": {n: p.detach().clone() for n, p in tr.model.named_parameters()},
            "ema": [e.clone() for e in tr.ema.params], "trainer": tr}


def nll_case(case: dict, rank: int, world: int) -> dict:
    """``nll_laplace`` on this rank's rows and its gradient for them."""
    gt, est, lv, mask = (shard_batch(torch.as_tensor(x), rank, world) for x in case["inputs"])
    est = est.clone().requires_grad_(True)
    value = nll_laplace(gt, est, lv, mask)
    value.backward()
    return {"value": float(value), "grad": est.grad.clone(),
            "valid": int((torch.isfinite(gt) & mask).sum())}


def _gathered(tr: DGMTrainer) -> dict:
    """The trainer's whole state as its checkpoint holds it (gathered)."""
    sd = tr.state_dict()
    return {"step": sd["step"], "model": sd["model"], "ema": sd["ema"],
            "opt": {i: {k: v.clone() for k, v in st.items()}
                    for i, st in sd["opt"]["state"].items()}}


def shard_case(case: dict, root: str) -> dict:
    """``DGMTrainConfig(shard_params=True)`` over a (world / 2, 2) mesh: two
    steps on this data index's rows with the global draws injected, what
    each rank stores, a sharded checkpoint, sampling, and a replicated
    checkpoint loaded into a sharded trainer."""
    mesh = make_mesh(model=2)
    out = {"mesh": (mesh.data, mesh.model, mesh.data_index, mesh.model_index),
           "data_group": dist.get_process_group_ranks(mesh.data_group),
           "model_group": dist.get_process_group_ranks(mesh.model_group)}
    cfg = dataclasses.replace(
        dgm_config(case["batch"], case["accum"], case["lr"], case["ema_every"]), shard_params=True)
    tr = DGMTrainer(cfg, mesh=mesh, device="cpu")
    tr.init_state()
    tr.load_params(case["params"])
    names = [n for n, _ in tr.model.named_parameters()]
    out["shard_dims"] = {names[i]: tr._shards.dims[i] for i in tr._shards.sharded}
    out["losses"], out["grad_norms"] = [], []
    for (img, cls), draws in zip(case["data"], case["draws"]):
        rows = [shard_batch(x, mesh.data_index, mesh.data, case["accum"]) for x in (img, cls)]
        step = tr.train_step(*rows, draws=draws)
        out["losses"].append(float(step["loss"]))
        out["grad_norms"].append(float(step["grad_norm"]))
    st = tr.optimizer.state
    out["stored"] = {n: (m.numel(), st[m]["exp_avg"].numel(), st[m]["exp_avg_sq"].numel(),
                         e.numel(), p.numel())
                     for n, m, e, p in zip(names, tr.masters, tr.ema.params,
                                           tr.model.parameters())}
    out["stored_elements"] = tr.stored_elements()
    out["masters"] = [m.detach().clone() for m in tr.masters]
    out["state"] = _gathered(tr)
    out["ckpt"] = tr.save(os.path.join(root, "sharded"))
    cond, cls = case["sample"]
    out["sample"] = tr.sample(torch.as_tensor(cls), torch.as_tensor(cond[..., 7:10]),
                              torch.as_tensor(cond[..., 6:7]),
                              generator=torch.Generator().manual_seed(3))
    back = DGMTrainer(cfg, mesh=mesh, device="cpu")
    back.init_state(seed=11)  # other weights: the load must replace them all
    back.load(case["replicated"])
    out["loaded"] = _gathered(back)
    out["loaded_masters"] = [m.detach().clone() for m in back.masters]
    out["loaded_ema"] = [e.clone() for e in back.ema.params]
    return out


def main(argv) -> None:
    root, rank, world = argv[0], int(argv[1]), int(argv[2])
    torch.set_num_threads(1)
    inputs = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    maybe_initialize_distributed(backend="gloo", init_method=f"file://{root}/pg",
                                 world_size=world, rank=rank, device="cpu", timeout_s=TIMEOUT_S)
    if argv[3:] == ["shard"]:
        try:
            torch.save(shard_case(inputs["shard"], root), os.path.join(root, f"rank{rank}.pt"))
        finally:
            dist.destroy_process_group()
        return
    try:
        out = {"world": dist.get_world_size(), "backend": dist.get_backend()}
        for name in ("hem_main", "hem_clamp"):
            out[name] = hem_steps(inputs[name], rank, world)
        out["dgm"] = dgm_step(inputs["dgm"], rank, world)
        out["nll"] = nll_case(inputs["nll"], rank, world)

        ev = inputs["eval"]
        tr = hem_trainer(ev, os.path.join(root, "hem"))
        rows = {k: v[rank::world] for k, v in ev["samples"].items()}  # this rank's shard
        out["eval"] = tr.evaluate(iter([rows]))

        # one writer: every rank saves, rank 0 alone writes
        tr.metrics.dump(os.path.join(root, "metrics", "val.json"), "val")
        out["paths"] = {"hem": tr.save(tag="latest"),
                        "dgm": out["dgm"].pop("trainer").save(os.path.join(root, "dgm"))}
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
