"""Data-parallel training across two processes against the JAX trainers on
a 2-device mesh, on the CPU.

One module fixture starts two ``gloo`` ranks (``tests/torch_dp_ranks.py``)
that run every case in one group, while this process builds the JAX and
single-process references; each test reads one part of their results.
Both sides start from the same random weights (drawn into the JAX trees'
shapes, carried to the port with ``load_params``), and each rank gets its
rows of the global batch by ``parallel/mesh.py::shard_batch``.

* HEM, global B=4 with grad_accum 4: JAX clamps ``accum`` to the per-device
  batch, 2, so that each global microbatch is 2 rows, one per rank, and
  BatchNorm normalises over both.  Two steps against the JAX trainer on
  ``make_mesh(jax.devices()[:2])`` with the tolerances
  ``tests/test_torch_train.py`` states for its 1-device mesh: the step-1
  loss 2e-6 relative, BatchNorm statistics 3e-5 of their largest value
  after step 1 and 2e-3 after step 2, the step-2 loss 1e-4 relative, the
  LR 1e-6, the parameters after 2 steps within 2 lr x 2 with fewer than 1%
  of the elements off by more than 1e-5.
* HEM, global B=8 with grad_accum 2 (microbatches of 4, 2 rows per rank),
  and the B=4 case above, against one process of the port on the global
  batch (held against JAX by ``test_torch_train.py``).  In step 1 only the
  order of fp32 sums separates the two (the ranks' partial sums, the
  one-pass BatchNorm variance ``E[x^2] - E[x]^2`` in place of
  ``var_mean``): the loss terms 1e-5 relative (phase 8c's rule in
  ``chip_smoke.py``), each gradient within 5e-4 of its largest |value| +
  1e-6 (``test_torch_train.py``'s rule), or within 10 times the change
  the reference's own gradient makes when the images move by 1e-7
  (``chip_smoke.py`` phase 9's rule: a one-channel BatchNorm's weight
  gradient sums dy * xhat over every row, terms whose absolute sum is
  ~800 times their sum in one microbatch here), BatchNorm statistics 1e-5
  of their largest value.  The parameters after each step within 2 lr per
  step (Adam's first steps move an element by about lr whatever its
  gradient's size, so a near-zero gradient may move it the other way),
  with fewer than 1% off by more than 1e-6 after step 1; step 2 runs on
  weights that differ so, hence ``test_torch_train.py``'s rules after step
  1: the loss terms 1e-4 relative, BatchNorm statistics 2e-3, fewer than
  1% of the parameters off by more than 1e-5.
* DGM, global B=4 in 2 microbatches with the draws of
  ``test_torch_dgm_train.py::_step_draws``: the loss 2e-6 relative, the
  global norm and the clip scale 1e-5 relative, the parameters after the
  step within 2 lr (fewer than 1% off by more than 1e-6), the EMA (every
  step, decay 0) the parameters, against the JAX trainer on a 2-device
  mesh; the gradients against one process of the port as above.
* The NLL on a batch whose ranks hold different counts of valid entries:
  the ranks' values average to the JAX NLL of the whole batch (1e-6
  relative), their gradients divided by the world size are its gradient
  (1e-6 of the largest); each rank's own mean, averaged, misses it.
* The merged ``evaluate`` equals one process's over all the samples
  (means 1e-6 relative, the same categories present); only rank 0 writes
  checkpoints and metric files.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmhomo_tpu.diffusion import DiffusionConfig as JaxDiffusionConfig
from dmhomo_tpu.losses import nll_laplace as jax_nll_laplace
from dmhomo_tpu.models.estimator import EstimatorConfig as JaxEstimatorConfig
from dmhomo_tpu.models.estimator import HomographyEstimator as JaxEstimator
from dmhomo_tpu.models.swin import SwinConfig as JaxSwinConfig
from dmhomo_tpu.models.unet import ConditionalUNet as JaxUNet
from dmhomo_tpu.models.unet import UNetConfig as JaxUNetConfig
from dmhomo_tpu.parallel import make_mesh
from dmhomo_tpu.train.config import DGMTrainConfig as JaxDGMConfig
from dmhomo_tpu.train.config import HEMTrainConfig as JaxHEMConfig
from dmhomo_tpu.train.dgm_trainer import DGMTrainer as JaxDGMTrainer
from dmhomo_tpu.train.ema import ema_init as jax_ema_init
from dmhomo_tpu.train.hem_trainer import HEMTrainer as JaxHEMTrainer

from dmhomo_torch.data.conditions import synthetic_condition_batches
from dmhomo_torch.evaluation.metrics import TEST_CATEGORIES
from dmhomo_torch.losses.hem_losses import nll_laplace
from dmhomo_torch.models.convert import estimator_state_dict_from_jax, unet_state_dict_from_jax
from dmhomo_torch.train.dgm_trainer import DGMTrainer
from torch_dp_ranks import dgm_config, hem_config, hem_trainer

WORLD = 2
STEPS_PER_EPOCH = 2
HEM_LR = 1e-4  # HEMTrainConfig's
DGM_LR = 5e-4
T, S, CLASSES = 1000, 16, 2
JOIN_TIMEOUT_S = 300  # the ranks' whole run; on expiry they are killed and the fixture fails


def _fill(shapes, rng):
    """Random values in the shapes of a JAX parameter or statistics tree:
    kernels N(0, 1/fan_in), norm scales and layer scales near 1 and 0.5,
    BatchNorm variances in [0.5, 1.5], everything else N(0, 0.05)."""
    out = {}
    for k, v in shapes.items():
        if isinstance(v, dict):
            out[k] = _fill(v, rng)
            continue
        shape = v.shape
        if k == "kernel":
            a = rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        elif k.startswith("gamma_"):
            a = rng.normal(0.5, 0.1, shape)
        elif k in ("scale", "g"):
            a = rng.normal(1.0, 0.05, shape)
        elif k == "var":
            a = rng.uniform(0.5, 1.5, shape)
        else:
            a = rng.normal(0, 0.05, shape)
        out[k] = a.astype(np.float32)
    return out


def _jax_hem_config(batch, grad_accum):
    swin = JaxSwinConfig(crop_size=(32, 64), embed_dim=8, depths=(1, 1, 1),
                         layer_depth=(3, 2, 1), num_heads=(2, 2, 4), window_size=4,
                         mlp_ratio=2.0)
    est = JaxEstimatorConfig(crop_size=(32, 64), ori_size=(40, 72), swin=swin)
    return JaxHEMConfig(estimator=est, bf16=False, remat=False, grad_accum=grad_accum,
                        train_batch_size=batch, seed=0)


def _jax_dgm_config(batch, accum):
    return JaxDGMConfig(
        unet=JaxUNetConfig(dim=8, dim_mults=(1, 2), num_classes=CLASSES),
        diffusion=JaxDiffusionConfig(image_size=S, timesteps=T, sampling_timesteps=4),
        train_batch_size=batch, gradient_accumulate_every=accum, bf16=False, lr=DGM_LR,
        ema_update_every=1, seed=0)


def _hem_batches(batch, n, seed):
    rng = np.random.default_rng(seed)
    return [{"imgs_gray_patch": rng.normal(0, 1, (batch, 32, 64, 2)).astype(np.float32),
             "flow_gt_patch": rng.normal(0, 3, (batch, 32, 64, 4)).astype(np.float32)}
            for _ in range(n)]


def _step_draws(key, batch, accum):
    """Per microbatch, (t, noise, keep_mask) as the JAX step draws them from
    its key (``test_torch_dgm_train.py::_step_draws``)."""
    out = []
    for k in jax.random.split(key, accum):
        key_t, key_loss = jax.random.split(k)
        n = batch // accum
        t = jax.random.randint(key_t, (n,), 0, T)
        key_noise, key_drop = jax.random.split(key_loss)
        noise = jax.random.normal(key_noise, (n, S, S, 6), jnp.float32)
        keep = jax.random.uniform(key_drop, (n,)) < 0.5
        out.append(tuple(np.array(a) for a in (t, noise, keep)))
    return out


def _nll_inputs(rng):
    """(gt, est, log_var, mask) of 4 rows at 8x8; rank 0's rows (0 and 1)
    hold many non-finite ground-truth entries and masked-out ones, rank
    1's few, so that their counts of valid entries differ."""
    gt = rng.normal(0, 2, (4, 8, 8, 2)).astype(np.float32)
    est = rng.normal(0, 2, (4, 8, 8, 2)).astype(np.float32)
    lv = rng.normal(0, 0.5, (4, 8, 8, 1)).astype(np.float32)
    mask = rng.uniform(size=(4, 8, 8, 2)) < np.array([0.4, 0.5, 0.9, 0.95])[:, None, None, None]
    gt[:2][rng.uniform(size=(2, 8, 8, 2)) < 0.3] = np.inf
    return gt, est, lv, mask


def _eval_samples(rng, n=8):
    names = [ids[0] for ids in TEST_CATEGORIES.values()]
    return {"imgs_gray_patch": rng.normal(0, 1, (n, 32, 64, 2)).astype(np.float32),
            "pt_set": rng.uniform(0, 39, (n, 6, 2, 2)).astype(np.float32),
            "video_names": [names[i % 3] for i in range(n)]}  # 3 of the 5 categories


def _hem_reference(case):
    """One process of the port on the global batches; and its step-1
    gradients with the images nudged by 1e-7."""
    tr = hem_trainer(case)
    out = {"losses": [], "states": []}
    for k, batch in enumerate(case["batches"]):
        out["losses"].append({n: float(v) for n, v in tr.train_step(batch).items()})
        if k == 0:
            out["grads"] = {n: p.grad.clone() for n, p in tr.model.named_parameters()}
        out["states"].append({n: v.clone() for n, v in tr.model.state_dict().items()})
    batch = dict(case["batches"][0])
    imgs = batch["imgs_gray_patch"]
    batch["imgs_gray_patch"] = (imgs + 1e-7 * np.random.default_rng(9).normal(
        size=imgs.shape)).astype(np.float32)
    tr = hem_trainer(case)
    tr.train_step(batch)
    out["grads_nudged"] = {n: p.grad.clone() for n, p in tr.model.named_parameters()}
    return out


def _jax_hem(case):
    jt = JaxHEMTrainer(_jax_hem_config(case["batch"], case["grad_accum"]),
                       mesh=make_mesh(jax.devices()[:WORLD]), steps_per_epoch=STEPS_PER_EPOCH)
    p = jax.tree.map(jnp.asarray, case["params"])
    jt.state = {"params": p, "batch_stats": jax.tree.map(jnp.asarray, case["stats"]),
                "opt_state": jt.tx.init(p), "step": jnp.zeros((), jnp.int32),
                "epoch": jnp.zeros((), jnp.int32)}
    out = {"losses": [], "states": []}
    for batch in case["batches"]:
        out["losses"].append({k: float(v) for k, v in jt.train_step(dict(batch)).items()})
        out["states"].append(estimator_state_dict_from_jax(
            jax.tree.map(np.asarray, jax.device_get(jt.state["params"])),
            jax.tree.map(np.asarray, jax.device_get(jt.state["batch_stats"])),
            hem_config(4, 4).estimator))
    return out


def _jax_dgm(case):
    jt = JaxDGMTrainer(_jax_dgm_config(case["batch"], case["accum"]),
                       mesh=make_mesh(jax.devices()[:WORLD]))
    p = jax.tree.map(jnp.asarray, case["params"])
    state = {"params": p, "opt_state": jt.tx.init(p), "ema": jax_ema_init(p),
             "step": jnp.zeros((), jnp.int32)}
    jt.state_shardings = jt._state_shardings(state)
    jt.state = state
    loss = float(jt.train_step(*case["data"], case["key"]))
    cfg = dgm_config(case["batch"], case["accum"], DGM_LR, 1).unet
    return {"loss": loss,
            "params": unet_state_dict_from_jax(
                jax.tree.map(np.asarray, jax.device_get(jt.state["params"])), cfg),
            "ema": unet_state_dict_from_jax(
                jax.tree.map(np.asarray, jax.device_get(jt.state["ema"].params)), cfg)}


def _run_ranks(root, inputs, world=WORLD, *case):
    """Start ``world`` ranks (``case``: the script's optional last
    argument); returns a function that joins them (killing them on expiry)
    and returns their results."""
    torch.save(inputs, os.path.join(root, "inputs.pt"))
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_dp_ranks.py")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(script)), env.get("PYTHONPATH", "")])
    procs = [subprocess.Popen([sys.executable, script, root, str(r), str(world), *case],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]

    def join():
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=JOIN_TIMEOUT_S)[0].decode(errors="replace"))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
        assert not failed, f"ranks failed {failed}:\n" + "\n".join(logs)
        return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]

    return join


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results beside the JAX and single-process references."""
    root = str(tmp_path_factory.mktemp("dp"))
    rng = np.random.default_rng(0)
    est = JaxEstimator(_jax_hem_config(4, 4).estimator)
    shapes = jax.eval_shape(lambda k: est.init(k, jnp.zeros((1, 32, 64, 2)), train=False),
                            jax.random.PRNGKey(0))
    params, stats = _fill(shapes["params"], rng), _fill(shapes["batch_stats"], rng)
    hem = {"params": params, "stats": stats, "steps_per_epoch": STEPS_PER_EPOCH}
    unet = JaxUNet(_jax_dgm_config(4, 2).unet)
    dummy = dict(x=jnp.zeros((1, S, S, 6)), time=jnp.zeros((1,), jnp.int32),
                 classes=jnp.zeros((1,), jnp.int32), rgb_flow=jnp.zeros((1, S, S, 3)),
                 mask=jnp.ones((1, S, S, 1)), keep_mask=jnp.ones((1,), bool))
    unet_shapes = jax.eval_shape(lambda k: unet.init(k, **dummy), jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(5)
    inputs = {
        "hem_main": {**hem, "batch": 8, "grad_accum": 2, "batches": _hem_batches(8, 2, 1)},
        "hem_clamp": {**hem, "batch": 4, "grad_accum": 4, "batches": _hem_batches(4, 2, 2)},
        "dgm": {"params": _fill(unet_shapes["params"], rng), "batch": 4, "accum": 2,
                "lr": DGM_LR, "ema_every": 1, "draws": _step_draws(key, 4, 2),
                "data": next(synthetic_condition_batches(8, S, 4, CLASSES, seed=2))},
        "nll": {"inputs": _nll_inputs(rng)},
        "eval": {**hem, "batch": 4, "grad_accum": 4, "samples": _eval_samples(rng)},
    }
    join = _run_ranks(root, inputs)

    # meanwhile, the references
    ref = {"hem_main": _hem_reference(inputs["hem_main"]),
           # one process at JAX's clamped accum: the same microbatches
           "hem_clamp": _hem_reference({**inputs["hem_clamp"], "grad_accum": 2}),
           "jax_hem_clamp": _jax_hem(inputs["hem_clamp"])}
    d = inputs["dgm"]
    tr = DGMTrainer(dgm_config(4, 2, DGM_LR, 1), device="cpu")
    tr.init_state()
    tr.load_params(d["params"])
    ref["dgm_loss"] = float(tr.loss_and_grads(*d["data"], draws=d["draws"]))
    ref["dgm_grads"] = {n: p.grad.clone() for n, p in tr.model.named_parameters()}
    ref["jax_dgm"] = _jax_dgm({**d, "key": key})
    gt, est_flow, lv, mask = (jnp.asarray(a) for a in inputs["nll"]["inputs"])
    value, grad = jax.value_and_grad(lambda e: jax_nll_laplace(gt, e, lv, mask))(est_flow)
    ref["jax_nll"] = (float(value), np.asarray(grad))
    ev = hem_trainer(inputs["eval"])
    ref["eval"] = ev.evaluate(iter([inputs["eval"]["samples"]]))
    return {"ranks": join(), "ref": ref, "inputs": inputs, "root": root}


def _rel(a, b) -> float:
    return abs(a - b) / abs(b)


def _close_states(got, want, bn_tol, w_tol, off_tol):
    """BatchNorm statistics within ``bn_tol`` of their largest value, the
    other entries within ``w_tol``, fewer than 1% off by more than ``off_tol``."""
    diffs = []
    for n, v in want.items():
        if n.endswith(("num_batches_tracked", "h_net.basis")):
            continue
        d = (torch.as_tensor(got[n]) - torch.as_tensor(v)).abs()
        if "running_" in n:
            assert float(d.max()) <= bn_tol * float(torch.as_tensor(v).abs().max()), n
        else:
            assert float(d.max()) <= w_tol, n
            diffs.append(d.flatten())
    assert float((torch.cat(diffs) > off_tol).float().mean()) < 0.01


def test_ranks_ran_one_gloo_group(runs):
    assert [(r["world"], r["backend"]) for r in runs["ranks"]] == [(WORLD, "gloo")] * WORLD
    # B=4, grad_accum 4: JAX's per-device clamp gives 2 microbatches; B=8, grad_accum 2: 2
    assert [r["hem_clamp"]["accum"] for r in runs["ranks"]] == [2, 2]
    assert [r["hem_main"]["accum"] for r in runs["ranks"]] == [2, 2]


def test_hem_steps_match_jax_on_a_2_device_mesh(runs):
    """Global B=4, grad_accum 4 (clamped to 2): the loss terms of 2 steps, the
    LR, BatchNorm statistics after each step and the parameters after both."""
    jx = runs["ref"]["jax_hem_clamp"]
    for r in runs["ranks"]:
        got = r["hem_clamp"]
        for k in range(2):
            for n, v in jx["losses"][k].items():
                assert got["losses"][k][n] == pytest.approx(v, rel=2e-6 if k == 0 else 1e-4,
                                                            abs=1e-12), (k, n)
        for n, v in jx["states"][0].items():
            if "running_" in n:
                tol = 3e-5 * float(v.abs().max())
                assert float((got["states"][0][n] - v).abs().max()) <= tol, n
        _close_states(got["states"][1], jx["states"][1], 2e-3, 2 * 2 * HEM_LR, 1e-5)
        assert got["lr"] == pytest.approx(HEM_LR * 0.8, rel=1e-6)  # one staircase decay


@pytest.mark.parametrize("case", ["hem_main", "hem_clamp"])
def test_hem_step_matches_one_process(runs, case):
    """Every rank's gradients, loss terms, BatchNorm statistics and weights
    against one process of the port on the global batch."""
    ref = runs["ref"][case]
    for r in runs["ranks"]:
        got = r[case]
        for k in range(2):
            for n, v in ref["losses"][k].items():
                assert got["losses"][k][n] == pytest.approx(v, rel=1e-5 if k == 0 else 1e-4,
                                                            abs=1e-12), (k, n)
            _close_states(got["states"][k], ref["states"][k], 1e-5 if k == 0 else 2e-3,
                          2 * (k + 1) * HEM_LR, 1e-6 if k == 0 else 1e-5)
        for n, g in ref["grads"].items():
            noise = float((ref["grads_nudged"][n] - g).abs().max())
            tol = max(5e-4 * float(g.abs().max()) + 1e-6, 10 * noise)
            assert float((got["grads"][n] - g).abs().max()) <= tol, n


def test_ranks_hold_the_same_state(runs):
    """The step's collectives leave every rank with the same weights and
    statistics, bit for bit."""
    a, b = runs["ranks"]
    for case in ("hem_main", "hem_clamp"):
        for n, v in a[case]["states"][-1].items():
            assert torch.equal(v, b[case]["states"][-1][n]), (case, n)
    for n, v in a["dgm"]["params"].items():
        assert torch.equal(v, b["dgm"]["params"][n]), n


def test_dgm_step_matches_jax_on_a_2_device_mesh(runs):
    jx = runs["ref"]["jax_dgm"]
    for r in runs["ranks"]:
        got = r["dgm"]
        assert got["loss"] == pytest.approx(jx["loss"], rel=2e-6)
        norm = float(torch.linalg.vector_norm(torch.stack(
            [g.norm() for g in runs["ref"]["dgm_grads"].values()])))
        assert got["grad_norm"] == pytest.approx(norm, rel=1e-5)
        assert got["clip_scale"] == pytest.approx(min(1.0, 1.0 / norm), rel=1e-5)
        diffs = []
        for n, v in jx["params"].items():
            d = (got["params"][n] - v).abs()
            assert float(d.max()) <= 2 * DGM_LR + 1e-6, n
            diffs.append(d.flatten())
        assert float((torch.cat(diffs) > 1e-6).float().mean()) < 0.01
        for n, e in zip(got["params"], got["ema"]):  # in the model's parameter order
            assert torch.equal(e, got["params"][n]), n  # decay 0, an update every step


def test_dgm_gradients_match_one_process(runs):
    ref = runs["ref"]
    for r in runs["ranks"]:
        assert r["dgm"]["loss"] == pytest.approx(ref["dgm_loss"], rel=1e-5)
        for n, g in ref["dgm_grads"].items():
            tol = 5e-4 * float(g.abs().max()) + 1e-6
            assert float((r["dgm"]["grads"][n] - g).abs().max()) <= tol, n


def test_nll_takes_the_global_count(runs):
    """Ranks with different counts of valid entries: the ranks' values
    average to the NLL of the whole batch and their gradients (over the
    world size) are its gradient; averaging each rank's own mean misses."""
    want, want_grad = runs["ref"]["jax_nll"]
    ranks = [r["nll"] for r in runs["ranks"]]
    assert ranks[0]["valid"] != ranks[1]["valid"]
    assert np.mean([r["value"] for r in ranks]) == pytest.approx(want, rel=1e-6)
    grad = torch.cat([r["grad"] for r in ranks]).numpy() / WORLD
    np.testing.assert_allclose(grad, want_grad, rtol=0, atol=1e-6 * np.abs(want_grad).max())
    gt, est, lv, mask = (torch.as_tensor(a) for a in runs["inputs"]["nll"]["inputs"])
    per_rank = np.mean([float(nll_laplace(gt[r * 2:(r + 1) * 2], est[r * 2:(r + 1) * 2],
                                          lv[r * 2:(r + 1) * 2], mask[r * 2:(r + 1) * 2]))
                        for r in range(WORLD)])
    assert _rel(per_rank, want) > 1e-2


def test_merged_evaluate_equals_one_process(runs):
    want = runs["ref"]["eval"]
    assert sum(not np.isnan(v) for v in want.values()) == 4  # 3 categories and AVG
    for r in runs["ranks"]:
        got = r["eval"]
        assert set(got) == set(want)
        for k, v in want.items():
            if np.isnan(v):
                assert np.isnan(got[k]), k
            else:
                assert got[k] == pytest.approx(v, rel=1e-6), k


def test_only_rank_0_writes(runs):
    root = runs["root"]
    a, b = (r["paths"] for r in runs["ranks"])
    assert a == b
    assert os.listdir(os.path.join(root, "hem")) == ["model_latest.pth"]
    assert os.listdir(os.path.join(root, "dgm")) == ["model-1.pt"]
    assert os.listdir(os.path.join(root, "metrics")) == ["val.json"]
    assert a["hem"] == os.path.join(root, "hem", "model_latest.pth")
