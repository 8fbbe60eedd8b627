"""The port's HEM training step with ``attn_impl='fused_block'`` against the
JAX package's, on the CPU.

The tiny config of ``tests/test_torch_train.py`` (window 4, fp32, no remat,
batch 4) from the same perturbed weights, with every Swin block as one
whole block: the JAX side through the Pallas ``fused_swin_block`` and its
``custom_vjp`` backward (interpret mode, under ``jit``), the port through
``SwinBlockFunction`` and its plain forward and backward.  Step-1 loss and
gradients are held to the tolerances of ``test_step1_gradients_match_jax``.
The JAX gradient is computed once, in a module fixture (it takes most of
this file's time).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmhomo_tpu.losses import compute_losses as jax_compute_losses
from dmhomo_tpu.models.estimator import HomographyEstimator as JaxEstimator
from dmhomo_tpu.parallel import make_mesh
from dmhomo_tpu.train.hem_trainer import HEMTrainer as JaxTrainer

from dmhomo_torch.losses.hem_losses import compute_losses
from dmhomo_torch.models.convert import estimator_state_dict_from_jax
from dmhomo_torch.models.swin import SwinBlock
from dmhomo_torch.train.hem_trainer import HEMTrainer

from test_torch_train import B, STEPS_PER_EPOCH, _jax_config, _perturb, _port_config


@pytest.fixture(scope="module")
def step1():
    """(params, batch_stats, batch, JAX loss, JAX gradients as a port state dict)."""
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = _jax_config(1)
    jt = JaxTrainer(cfg, mesh=make_mesh(jax.devices()[:1]), steps_per_epoch=STEPS_PER_EPOCH)
    jt.init_state()
    params = _perturb(jax.tree.map(np.asarray, jax.device_get(jt.state["params"])),
                      np.random.default_rng(1))
    stats = _perturb(jax.tree.map(np.asarray, jax.device_get(jt.state["batch_stats"])),
                     np.random.default_rng(2))
    rng = np.random.default_rng(3)
    batch = {"imgs_gray_patch": rng.normal(0, 1, (B, 32, 64, 2)).astype(np.float32),
             "flow_gt_patch": rng.normal(0, 3, (B, 32, 64, 4)).astype(np.float32)}
    est = dataclasses.replace(cfg.estimator, swin=dataclasses.replace(
        cfg.estimator.swin, attn_impl="fused_block"))
    model = JaxEstimator(est)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        out, _ = model.apply({"params": p, "batch_stats": stats}, jbatch["imgs_gray_patch"],
                             train=True, mutable=["batch_stats"])
        return jax_compute_losses(jbatch, out, cfg.loss)["total"]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    yield params, stats, batch, float(loss), jax.tree.map(np.asarray, grads)
    torch.set_num_threads(torch_threads)


def test_step1_gradients_match_jax_fused_block(step1):
    params, stats, batch, want_loss, grads = step1
    cfg = dataclasses.replace(_port_config(1), attn_impl="fused_block")
    tr = HEMTrainer(cfg, steps_per_epoch=STEPS_PER_EPOCH, device="cpu")
    tr.init_state()
    tr.load_params(params, stats)
    blocks = [m for m in tr.model.modules() if isinstance(m, SwinBlock)]
    assert len(blocks) == 6 and all(m.fused for m in blocks)
    assert not tr.model.h_net.encoder_layers[0].remat
    want = estimator_state_dict_from_jax(grads, stats, tr.model.config)
    tr.model.train()
    out = tr.model(torch.from_numpy(batch["imgs_gray_patch"]))
    loss = compute_losses({"flow_gt_patch": torch.from_numpy(batch["flow_gt_patch"])},
                          out, tr.config.loss)["total"]
    loss.backward()
    assert float(loss.detach()) == pytest.approx(want_loss, rel=2e-6)
    for name, p in tr.model.named_parameters():
        g = want[name]
        tol = 5e-4 * float(g.abs().max()) + 1e-6
        assert float((p.grad - g).abs().max()) <= tol, name
