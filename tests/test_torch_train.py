"""The port's HEM training against the JAX package's, on the CPU.

A tiny config (crop 32x64, every Swin level, merge and class-attention
block of the shipped architecture at small widths), fp32, no remat, batch
4.  Both sides start from the same weights (JAX init, perturbed so that the
layer scales and BatchNorm statistics are not trivial, carried over with
``estimator_state_dict_from_jax``), take 3 steps on the same 3 batches with
2 steps per epoch (so the LR staircase decays once), and the JAX trainer
runs on a 1-device mesh (so that ``grad_accum`` is not clamped to 1).

Tolerances.  Step 1 starts from the same weights, so only fp32 summation
order through the three coarse-to-fine levels separates the two:
* step-1 gradients: 5e-4 of each tensor's largest |gradient|, + 1e-6;
* step-1 loss: 2e-6 relative; BatchNorm running statistics after step 1:
  3e-5 of the largest value; LR values 1e-6 relative.
After that, Adam moves an element whose gradient is near zero by about
+-lr whatever its size, so its sign may differ between the frameworks and
the weights drift apart by up to 2 lr per step on a few elements:
* losses of steps 2 and 3: 1e-4 relative;
* BatchNorm running statistics after step 3: 2e-3 of the largest value;
* parameters after step 3: 6e-4 absolute (2 lr x 3 steps), with fewer
  than 1% of the elements off by more than 1e-5.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmhomo_tpu.losses import compute_losses as jax_compute_losses
from dmhomo_tpu.models.estimator import EstimatorConfig as JaxEstimatorConfig
from dmhomo_tpu.models.estimator import HomographyEstimator as JaxEstimator
from dmhomo_tpu.models.swin import SwinConfig as JaxSwinConfig
from dmhomo_tpu.parallel import make_mesh
from dmhomo_tpu.train.config import HEMTrainConfig as JaxTrainConfig
from dmhomo_tpu.train.config import Params as JaxParams
from dmhomo_tpu.train.hem_trainer import HEMTrainer as JaxTrainer
from dmhomo_tpu.train.hem_trainer import resolve_attn_impl as jax_resolve_attn_impl
from dmhomo_tpu.train.hem_trainer import resolve_remat as jax_resolve_remat

from dmhomo_torch.cli.hem_train import tiny_config
from dmhomo_torch.config import EstimatorConfig, Params, SwinConfig
from dmhomo_torch.losses.hem_losses import compute_losses
from dmhomo_torch.models.convert import estimator_state_dict_from_jax
from dmhomo_torch.models.swin import BatchNorm2d
from dmhomo_torch.train.config import (
    HEMTrainConfig,
    estimator_for_training,
    resolve_attn_impl,
    resolve_remat,
)
from dmhomo_torch.train.hem_trainer import HEMTrainer

B = 4
STEPS_PER_EPOCH = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are small: one torch thread is faster than many, and
    the suite runs test files side by side in worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_config(accum):
    swin = JaxSwinConfig(crop_size=(32, 64), embed_dim=8, depths=(1, 1, 1),
                         layer_depth=(3, 2, 1), num_heads=(2, 2, 4), window_size=4,
                         mlp_ratio=2.0)
    est = JaxEstimatorConfig(crop_size=(32, 64), ori_size=(40, 72), swin=swin)
    return JaxTrainConfig(estimator=est, bf16=False, remat=False, grad_accum=accum,
                          train_batch_size=B, seed=0)


def _port_config(accum):
    return dataclasses.replace(tiny_config(3, False, "unused"), bf16=False, remat=False,
                               grad_accum=accum, train_batch_size=B)


def _perturb(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
            continue
        v = np.asarray(v, np.float32)
        if k.startswith("gamma_"):
            v = rng.normal(0.5, 0.1, v.shape)
        elif k == "var":
            v = rng.uniform(0.5, 1.5, v.shape)
        else:
            v = v + rng.normal(0, 0.05, v.shape)
        out[k] = v.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def start():
    """(params, batch_stats, 3 batches) shared by both frameworks."""
    jt = JaxTrainer(_jax_config(1), mesh=make_mesh(jax.devices()[:1]),
                    steps_per_epoch=STEPS_PER_EPOCH)
    jt.init_state()
    params = _perturb(jax.tree.map(np.asarray, jax.device_get(jt.state["params"])),
                      np.random.default_rng(1))
    stats = _perturb(jax.tree.map(np.asarray, jax.device_get(jt.state["batch_stats"])),
                     np.random.default_rng(2))
    rng = np.random.default_rng(0)
    batches = [{"imgs_gray_patch": rng.normal(0, 1, (B, 32, 64, 2)).astype(np.float32),
                "flow_gt_patch": rng.normal(0, 3, (B, 32, 64, 4)).astype(np.float32)}
               for _ in range(3)]
    return params, stats, batches


def _port_trainer(accum, params, stats):
    tr = HEMTrainer(_port_config(accum), steps_per_epoch=STEPS_PER_EPOCH, device="cpu")
    tr.init_state()
    tr.load_params(params, stats)
    return tr


def test_step1_gradients_match_jax(start):
    params, stats, batches = start
    cfg = _jax_config(1)
    model = JaxEstimator(cfg.estimator)
    batch = {k: jnp.asarray(v) for k, v in batches[0].items()}

    def loss_fn(p):
        out, _ = model.apply({"params": p, "batch_stats": stats}, batch["imgs_gray_patch"],
                             train=True, mutable=["batch_stats"])
        return jax_compute_losses(batch, out, cfg.loss)["total"]

    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tr = _port_trainer(1, params, stats)
    want = estimator_state_dict_from_jax(jax.tree.map(np.asarray, grads), stats,
                                         tr.model.config)
    tr.model.train()
    out = tr.model(torch.from_numpy(batches[0]["imgs_gray_patch"]))
    loss = compute_losses({"flow_gt_patch": torch.from_numpy(batches[0]["flow_gt_patch"])},
                          out, tr.config.loss)["total"]
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=2e-6)
    names = [n for n, _ in tr.model.named_parameters()]
    assert "h_net.encoder_layers.0.layer.0.attn.relative_position_bias_table" in names
    for name, p in tr.model.named_parameters():
        g = want[name]
        tol = 5e-4 * float(g.abs().max()) + 1e-6
        assert float((p.grad - g).abs().max()) <= tol, name


def _state_dicts(jt, tr):
    """(JAX state as a port state dict, the port's state dict), without the
    buffers that never change."""
    want = estimator_state_dict_from_jax(
        jax.tree.map(np.asarray, jax.device_get(jt.state["params"])),
        jax.tree.map(np.asarray, jax.device_get(jt.state["batch_stats"])), tr.model.config)
    skip = ("num_batches_tracked", "h_net.basis")
    return ({k: v for k, v in want.items() if not k.endswith(skip)}, tr.model.state_dict())


@pytest.mark.parametrize("accum", [1, 2])
def test_training_steps_match_jax(start, accum):
    """3 steps: losses, LR values, BN running stats and parameters."""
    import optax

    params, stats, batches = start
    jt = JaxTrainer(_jax_config(accum), mesh=make_mesh(jax.devices()[:1]),
                    steps_per_epoch=STEPS_PER_EPOCH)
    jt.init_state()
    jt.load_params(params, stats)
    tr = _port_trainer(accum, params, stats)
    schedule = optax.exponential_decay(1e-4, STEPS_PER_EPOCH, 0.8, staircase=True)
    for k, b in enumerate(batches):
        want_loss = float(jt.train_step(dict(b))["total"])
        assert tr.lr == pytest.approx(float(schedule(k)), rel=1e-6)
        got_loss = float(tr.train_step(b)["total"])
        assert got_loss == pytest.approx(want_loss, rel=2e-6 if k == 0 else 1e-4)
        if k == 0:  # the running stats of step 1 come from the shared weights
            want, got = _state_dicts(jt, tr)
            for n, v in want.items():
                if "running_" in n:
                    assert float((got[n] - v).abs().max()) <= 3e-5 * float(v.abs().max()), n
    assert (tr.step, tr.epoch) == (3, 1)

    want, got = _state_dicts(jt, tr)
    diffs = []
    for n, v in want.items():
        d = (got[n] - v).abs()
        if "running_" in n:
            assert float(d.max()) <= 2e-3 * float(v.abs().max()), n
        else:
            assert float(d.max()) <= 6e-4, n
            diffs.append(d.flatten())
    assert float((torch.cat(diffs) > 1e-5).float().mean()) < 0.01


def test_batchnorm_running_var_is_biased():
    """Training mode moves the running variance toward the biased batch
    variance (Flax), where torch's BatchNorm2d takes the unbiased one; the
    normalized output is the same."""
    x = torch.from_numpy(np.random.default_rng(0).normal(1, 2, (2, 3, 4, 5)).astype(np.float32))
    ours, theirs = BatchNorm2d(3), torch.nn.BatchNorm2d(3)
    torch.testing.assert_close(ours(x), theirs(x))
    var = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(ours.running_var, 0.9 + 0.1 * var)
    torch.testing.assert_close(theirs.running_var, 0.9 + 0.1 * var * 40 / 39)
    torch.testing.assert_close(ours.running_mean, 0.1 * x.mean(dim=(0, 2, 3)))


def test_remat_gives_the_same_gradients():
    """SwinConfig.remat recomputes the Swin blocks in the backward
    (torch.utils.checkpoint): same loss and gradients."""
    rng = np.random.default_rng(4)
    imgs = torch.from_numpy(rng.normal(0, 1, (2, 32, 64, 2)).astype(np.float32))
    flows = torch.from_numpy(rng.normal(0, 3, (2, 32, 64, 4)).astype(np.float32))
    grads = []
    for remat in (False, True):
        tr = HEMTrainer(dataclasses.replace(_port_config(1), remat=remat), device="cpu")
        tr.init_state(7)
        assert tr.model.h_net.encoder_layers[0].remat is remat
        tr.model.train()
        compute_losses({"flow_gt_patch": flows}, tr.model(imgs), tr.config.loss)["total"].backward()
        grads.append({n: p.grad for n, p in tr.model.named_parameters()})
    for n, g in grads[0].items():
        torch.testing.assert_close(grads[1][n], g, rtol=0, atol=1e-6, msg=n)


IMPLS = ("auto", None, "xla", "pallas", "fused_block", "pallas,pallas,fused_block")
JAX_BACKEND = {"cuda": "tpu", "cpu": "cpu"}  # the port's card in the place of JAX's TPU


@pytest.mark.parametrize("requested", [True, False, "auto"])
@pytest.mark.parametrize("impl", IMPLS[1:])
@pytest.mark.parametrize("accum", [1, 2, 4, 8])
def test_resolve_remat(requested, impl, accum):
    """As the JAX trainer's: 'auto' is off only for the whole spec 'pallas'
    at grad_accum >= 4."""
    assert resolve_remat(requested, impl, accum) is jax_resolve_remat(requested, impl, accum)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("requested", IMPLS)
def test_resolve_attn_impl_matches_jax(requested, device):
    assert resolve_attn_impl(requested, device) == jax_resolve_attn_impl(
        requested, JAX_BACKEND[device])


@pytest.mark.parametrize("attn_impl", ["auto", None, "pallas", "fused_block"])
def test_trainers_resolve_the_same_estimator(attn_impl):
    """Both trainers built from a config whose estimator asks for
    'fused_block' end with the same Swin impl and remat: on the CPU (both
    trainers) and on the card against JAX's resolution on TPU."""
    swin = SwinConfig(attn_impl="fused_block")
    cfg = HEMTrainConfig(estimator=EstimatorConfig(swin=swin), attn_impl=attn_impl)
    jcfg = JaxTrainConfig(estimator=JaxEstimatorConfig(swin=JaxSwinConfig(attn_impl="fused_block")),
                          attn_impl=attn_impl)
    jswin = JaxTrainer(jcfg, mesh=make_mesh(jax.devices()[:1])).model.config.swin
    port = estimator_for_training(cfg, "cpu").swin
    assert (port.attn_impl, port.remat) == (jswin.attn_impl, jswin.remat)
    tr = HEMTrainer(cfg, device="cpu")
    tr.init_state()
    assert tr.model.h_net.encoder_layers[0].remat is port.remat
    card = estimator_for_training(cfg, "cuda").swin
    impl = jax_resolve_attn_impl(attn_impl, "tpu") or "fused_block"
    assert (card.attn_impl, card.remat) == (impl, jax_resolve_remat("auto", impl, 4))
    shipped = estimator_for_training(HEMTrainConfig(), "cuda").swin
    assert (shipped.attn_impl, shipped.remat) == ("pallas", False)


def test_bf16_token_dtypes_match_jax(monkeypatch):
    """Under bf16 the dtype entering each whole-block call, in call order,
    is the JAX bf16 estimator's: both halves of each level's token concat
    are cast to the activation dtype, as JAX does after its fp32 warp."""
    import dmhomo_tpu.ops.swin_block as jax_sb

    import dmhomo_torch.models.swin as port_swin
    from dmhomo_torch.models.estimator import HomographyEstimator

    seen = {"jax": [], "port": []}
    jax_block, port_block = jax_sb.fused_swin_block, port_swin.swin_block

    def jax_spy(x, *args, **kw):
        seen["jax"].append(jnp.dtype(x.dtype).name)
        return jax_block(x, *args, **kw)

    def port_spy(x, *args, **kw):
        seen["port"].append(str(x.dtype).split(".")[-1])
        return port_block(x, *args, **kw)

    monkeypatch.setattr(jax_sb, "fused_swin_block", jax_spy)
    monkeypatch.setattr(port_swin, "swin_block", port_spy)
    est = _jax_config(1).estimator
    est = dataclasses.replace(est, dtype=jnp.bfloat16, swin=dataclasses.replace(
        est.swin, dtype=jnp.bfloat16, sim_dtype=jnp.bfloat16, attn_impl="fused_block"))
    model = JaxEstimator(est)
    jax.eval_shape(lambda k: model.init(k, jnp.zeros((2, 32, 64, 2)), train=False),
                   jax.random.PRNGKey(0))
    cfg = _port_config(1).estimator
    cfg = dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, attn_impl="fused_block"))
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        HomographyEstimator(cfg)(torch.zeros(2, 32, 64, 2))
    assert len(seen["port"]) == 12 and seen["port"].count("bfloat16") == 6
    assert seen["port"] == seen["jax"]


def test_config_matches_jax(tmp_path):
    """Defaults, stage2() and from_params() give the JAX config's values."""
    path = tmp_path / "params.json"
    with open(path, "w") as f:
        json.dump({"learning_rate": 2e-4, "gamma": 0.5, "train_batch_size": 16,
                   "sup_loss_weight": 1.0, "normalize_mask": True, "train_num_steps": 50,
                   "crop_size": [64, 128], "ori_size": [72, 144], "embed_dim": 12}, f)
    pairs = [(HEMTrainConfig(), JaxTrainConfig()),
             (HEMTrainConfig.stage2(lr=3e-4), JaxTrainConfig.stage2(lr=3e-4)),
             (HEMTrainConfig.from_params(Params(str(path))),
              JaxTrainConfig.from_params(JaxParams(str(path))))]
    for ours, theirs in pairs:
        for f in ("lr", "gamma", "train_batch_size", "eval_batch_size", "num_epochs",
                  "train_num_steps", "rho", "major_metric", "seed", "bf16", "remat",
                  "grad_accum", "attn_impl"):
            assert getattr(ours, f) == getattr(theirs, f), f
        assert dataclasses.asdict(ours.loss) == dataclasses.asdict(theirs.loss)
        assert ours.estimator.crop_size == theirs.estimator.crop_size
        assert ours.estimator.ori_size == theirs.estimator.ori_size
        assert ours.estimator.swin.embed_dim == theirs.estimator.swin.embed_dim


def test_bf16_loss_close_to_jax(start):
    """bf16 (the shipped policy): the JAX estimator's bf16 modules (as its
    trainer sets them) against the port's forward under CPU autocast, both
    in training mode.  The two round at different places (autocast keeps
    LayerNorm and the class attention's softmax in fp32), so only the loss
    is held, at 3e-2 relative."""
    params, stats, batches = start
    cfg = _jax_config(1)
    est = cfg.estimator
    est = dataclasses.replace(est, dtype=jnp.bfloat16, swin=dataclasses.replace(
        est.swin, dtype=jnp.bfloat16, sim_dtype=jnp.bfloat16))
    batch = {k: jnp.asarray(v) for k, v in batches[0].items()}

    @jax.jit
    def loss_fn(p):
        out, _ = JaxEstimator(est).apply({"params": p, "batch_stats": stats},
                                         batch["imgs_gray_patch"], train=True,
                                         mutable=["batch_stats"])
        return jax_compute_losses(batch, out, cfg.loss)["total"]

    tr = _port_trainer(1, params, stats)
    tr.model.train()
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        out = tr.model(torch.from_numpy(batches[0]["imgs_gray_patch"]))
    got = compute_losses({"flow_gt_patch": torch.from_numpy(batches[0]["flow_gt_patch"])},
                         out, tr.config.loss)["total"]
    assert float(got) == pytest.approx(float(loss_fn(params)), rel=3e-2)
