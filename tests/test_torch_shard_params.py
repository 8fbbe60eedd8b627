"""``DGMTrainConfig(shard_params=True)``: parameters, Adam's moments and the
EMA channel-sharded over the mesh's ``model`` axis, against the JAX
package's ``DGMTrainer(shard_params=True)``, on the CPU.

* The rule (shapes only): the port shards the same leaves as JAX's
  ``channel_shardings`` at model 2 and 4, on the tiny UNet and the shipped
  dim-64 one.  The torch dim of each JAX leaf's last dim is found apart
  from the port's rule: every JAX leaf is filled with its own number and
  its last-dim index, converted by ``models/convert.py``, and each torch
  tensor read for the dim along which that index runs.
* Four ``gloo`` ranks (``tests/torch_dp_ranks.py ... shard``) on a (data 2,
  model 2) mesh, started by a module fixture while this process runs the
  references: the mesh places the ranks as JAX's ``reshape``; two steps
  (global batch 8 in 2 microbatches, the JAX draws of
  ``test_torch_dgm_train.py::_step_draws`` injected) give losses within
  1e-5 relative of JAX's on the conftest's (4, 2) mesh with the same keys,
  the global norms within 1e-5 of one process of the port, and the
  weights within 2 lr x 2 of one process (fewer than 1% off by more than
  1e-6), the EMA (an update every step, decay 0) the weights; the four
  ranks hold the same state bit for bit.
* Each rank stores half of each sharded leaf's parameter, Adam moments
  and EMA, and the whole of each replicated one.
* The checkpoint saved sharded (one file, rank 0's) loads into a
  replicated trainer with the same state, bit for bit; a replicated
  checkpoint loads into the sharded trainers, each rank holding its
  slices.  Sampling under ``shard_params`` is finite.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmhomo_tpu.diffusion import DiffusionConfig as JaxDiffusionConfig
from dmhomo_tpu.models.unet import ConditionalUNet as JaxUNet
from dmhomo_tpu.models.unet import UNetConfig as JaxUNetConfig
from dmhomo_tpu.parallel import channel_shardings as jax_channel_shardings
from dmhomo_tpu.parallel import make_mesh
from dmhomo_tpu.train.config import DGMTrainConfig as JaxDGMConfig
from dmhomo_tpu.train.dgm_trainer import DGMTrainer as JaxDGMTrainer
from dmhomo_tpu.train.ema import ema_init as jax_ema_init

from dmhomo_torch.data.conditions import synthetic_condition_batches
from dmhomo_torch.models.convert import unet_state_dict_from_jax
from dmhomo_torch.models.unet import ConditionalUNet, UNetConfig
from dmhomo_torch.parallel.mesh import mesh_coords
from dmhomo_torch.parallel.tp import channel_dims, channel_shardings
from dmhomo_torch.train.dgm_trainer import DGMTrainer
from test_torch_data_parallel import _fill, _run_ranks, _step_draws
from torch_dp_ranks import dgm_config

WORLD, MODEL = 4, 2
B, ACCUM, LR = 8, 2, 5e-4
S, CLASSES = 16, 2
TINY = dict(dim=8, dim_mults=(1, 2), num_classes=CLASSES)
SHIPPED = dict(dim=64, dim_mults=(1, 2, 4, 8), num_classes=5)


def _dummy(size):
    return dict(x=jnp.zeros((1, size, size, 6)), time=jnp.zeros((1,), jnp.int32),
                classes=jnp.zeros((1,), jnp.int32), rgb_flow=jnp.zeros((1, size, size, 3)),
                mask=jnp.ones((1, size, size, 1)), keep_mask=jnp.ones((1,), bool))


def _jax_shapes(widths):
    unet = JaxUNet(JaxUNetConfig(**widths))
    return jax.eval_shape(lambda k: unet.init(k, **_dummy(S)), jax.random.PRNGKey(0))["params"]


def _markers(shapes):
    """(the tree with leaf i filled with 1000 (i + 1) + its last-dim index,
    the leaves in flattening order)."""
    leaves, treedef = jax.tree.flatten(shapes)
    filled = []
    for i, leaf in enumerate(leaves):
        idx = np.arange(leaf.shape[-1], dtype=np.float32)
        filled.append(np.broadcast_to(1000.0 * (i + 1) + idx, leaf.shape).astype(np.float32))
    return jax.tree.unflatten(treedef, filled), leaves


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("widths", [TINY, SHIPPED], ids=["tiny", "shipped"])
def test_the_rule_shards_the_leaves_jax_shards(widths, model):
    shapes = _jax_shapes(widths)
    mesh = make_mesh(jax.devices()[:8], data=8 // model, model=model)
    specs = jax.tree.leaves(jax_channel_shardings(shapes, mesh),
                            is_leaf=lambda x: hasattr(x, "spec"))
    markers, leaves = _markers(shapes)
    cfg = UNetConfig(**widths)
    sd = unet_state_dict_from_jax(markers, cfg)
    with torch.device("meta"):
        port = ConditionalUNet(cfg)
    got = channel_shardings({n: tuple(p.shape) for n, p in port.named_parameters()},
                            channel_dims(port, unet_state_dict_from_jax, cfg), model)
    assert set(got) == set(sd)
    n_sharded = 0
    for name, t in sd.items():
        leaf = int(t.reshape(-1)[0]) // 1000 - 1
        jax_sharded = len(specs[leaf].spec) > 0 and specs[leaf].spec[-1] == "model"
        assert (got[name] is not None) == jax_sharded, name
        n_sharded += jax_sharded
        c = leaves[leaf].shape[-1]
        if c > 1:  # the dim along which the JAX leaf's last-dim index runs
            idx = t - 1000.0 * (leaf + 1)
            dims = [d for d in range(t.ndim) if t.shape[d] == c and torch.equal(
                idx, torch.arange(c, dtype=t.dtype).reshape(
                    [c if e == d else 1 for e in range(t.ndim)]).expand(t.shape))]
            assert len(dims) == 1, name
            if jax_sharded:
                assert got[name] == dims[0], name
    assert n_sharded > 0


@pytest.fixture(scope="module")
def shard_runs(tmp_path_factory):
    """The four ranks' results beside JAX's and one process's."""
    root = str(tmp_path_factory.mktemp("shard"))
    rng = np.random.default_rng(0)
    params = _fill(_jax_shapes(TINY), rng)
    batches = synthetic_condition_batches(16, S, B, CLASSES, seed=3)
    data = [next(batches) for _ in range(2)]
    keys = list(jax.random.split(jax.random.PRNGKey(7), 2))
    draws = [_step_draws(k, B, ACCUM) for k in keys]
    sample = next(synthetic_condition_batches(4, S, 2, CLASSES, seed=4))
    # a replicated checkpoint after one step, for the sharded trainers to load
    rep = DGMTrainer(dgm_config(B, ACCUM, LR, 1), device="cpu")
    rep.init_state(seed=5)
    rep.train_step(*data[0], draws=draws[0])
    rep_root = os.path.join(root, "replicated")
    rep.save(rep_root)
    case = {"params": params, "batch": B, "accum": ACCUM, "lr": LR, "ema_every": 1,
            "data": data, "draws": draws, "sample": sample, "replicated": rep_root}
    join = _run_ranks(root, {"shard": case}, WORLD, "shard")

    # meanwhile: one process of the port, and JAX on a (4, 2) mesh
    one = DGMTrainer(dgm_config(B, ACCUM, LR, 1), device="cpu")
    one.init_state()
    one.load_params(params)
    one_out = [one.train_step(img, cls, draws=d) for (img, cls), d in zip(data, draws)]
    jcfg = JaxDGMConfig(unet=JaxUNetConfig(**TINY),
                        diffusion=JaxDiffusionConfig(image_size=S, timesteps=1000,
                                                     sampling_timesteps=4),
                        train_batch_size=B, gradient_accumulate_every=ACCUM, bf16=False, lr=LR,
                        ema_update_every=1, seed=0, shard_params=True)
    jt = JaxDGMTrainer(jcfg, mesh=make_mesh(jax.devices()[:8], data=4, model=MODEL))
    p = jax.tree.map(jnp.asarray, params)
    state = {"params": p, "opt_state": jt.tx.init(p), "ema": jax_ema_init(p),
             "step": jnp.zeros((), jnp.int32)}
    jt.state_shardings = jt._state_shardings(state)
    jt.state = jax.tree.map(jax.device_put, state, jt.state_shardings)
    sharded_specs = [s.spec for s in jax.tree.leaves(jt.state_shardings["params"],
                                                     is_leaf=lambda x: hasattr(x, "spec"))]
    jax_losses = [float(jt.train_step(img, cls, k)) for (img, cls), k in zip(data, keys)]
    return {"ranks": join(), "root": root, "rep_root": rep_root,
            "one": {"losses": [float(o["loss"]) for o in one_out],
                    "norms": [float(o["grad_norm"]) for o in one_out],
                    "params": {n: p.detach().clone() for n, p in one.model.named_parameters()}},
            "jax_losses": jax_losses, "jax_specs": sharded_specs}


def test_mesh_places_the_ranks_as_jax(shard_runs):
    for r, got in enumerate(shard_runs["ranks"]):
        d, m = mesh_coords(r, MODEL)
        assert got["mesh"] == (WORLD // MODEL, MODEL, d, m)
        assert got["model_group"] == [d * MODEL + k for k in range(MODEL)]
        assert got["data_group"] == list(range(m, WORLD, MODEL))


def test_losses_match_jax_shard_params(shard_runs):
    assert any(len(s) and s[-1] == "model" for s in shard_runs["jax_specs"])
    for got in shard_runs["ranks"]:
        for k, want in enumerate(shard_runs["jax_losses"]):
            assert got["losses"][k] == pytest.approx(want, rel=1e-5), k


def test_step_matches_one_process(shard_runs):
    """The global norm (the slices' squares over the model group plus the
    replicated leaves'), the weights after two steps, the EMA."""
    one = shard_runs["one"]
    for got in shard_runs["ranks"]:
        for k in range(2):
            assert got["losses"][k] == pytest.approx(one["losses"][k], rel=1e-5)
            assert got["grad_norms"][k] == pytest.approx(one["norms"][k], rel=1e-5)
        diffs = []
        for n, v in one["params"].items():
            d = (got["state"]["model"][f"model.{n}"] - v).abs()
            assert float(d.max()) <= 2 * 2 * LR + 1e-6, n
            diffs.append(d.flatten())
        assert float((torch.cat(diffs) > 1e-6).float().mean()) < 0.01
        for n in one["params"]:  # decay 0 and an update every step: the EMA is the weights
            assert torch.equal(got["state"]["ema"][f"ema_model.model.{n}"],
                               got["state"]["model"][f"model.{n}"]), n


def test_ranks_hold_the_same_state(shard_runs):
    first = shard_runs["ranks"][0]["state"]
    for got in shard_runs["ranks"][1:]:
        for part in ("model", "ema"):
            for k, v in first[part].items():
                assert torch.equal(got["state"][part][k], v), (part, k)
        for i, st in first["opt"].items():
            for k, v in st.items():
                assert torch.equal(got["state"]["opt"][i][k], v), (i, k)


def test_each_rank_stores_half_of_each_sharded_leaf(shard_runs):
    for got in shard_runs["ranks"]:
        sharded = got["shard_dims"]
        assert sharded
        for name, (param, mu, nu, ema, full) in got["stored"].items():
            want = full // MODEL if name in sharded else full
            assert (param, mu, nu, ema) == (want,) * 4, name
        el = got["stored_elements"]
        assert el["sharded_stored"] * MODEL == el["sharded_full"]
        assert el["params"] == el["sharded_stored"] + el["replicated"] == el["ema"]
        assert el["adam"] == 2 * el["params"]


def test_slices_are_the_ranks_own(shard_runs):
    """Rank (d, m)'s master of a sharded leaf is slice m of the full weight
    along the leaf's channel dim."""
    for r, got in enumerate(shard_runs["ranks"]):
        m = mesh_coords(r, MODEL)[1]
        names = list(got["stored"])
        for name, master in zip(names, got["masters"]):
            full = got["state"]["model"][f"model.{name}"]
            if name in got["shard_dims"]:
                full = full.chunk(MODEL, got["shard_dims"][name])[m]
            assert torch.equal(master, full), name


def test_sharded_checkpoint_loads_replicated(shard_runs):
    """One file, written by rank 0; a replicated trainer that loads it
    holds the ranks' gathered state."""
    ranks = shard_runs["ranks"]
    root = os.path.join(shard_runs["root"], "sharded")
    assert os.listdir(root) == ["model-2.pt"]
    assert {got["ckpt"] for got in ranks} == {os.path.join(root, "model-2.pt")}
    tr = DGMTrainer(dgm_config(B, ACCUM, LR, 1), device="cpu")
    tr.init_state(seed=9)
    tr.load(root)
    want = ranks[0]["state"]
    assert tr.step == 2 and tr.ema.step == 2
    for n, p in tr.model.named_parameters():
        assert torch.equal(p.detach(), want["model"][f"model.{n}"]), n
    for n, e in zip((n for n, _ in tr.model.named_parameters()), tr.ema.params):
        assert torch.equal(e, want["ema"][f"ema_model.model.{n}"]), n
    state = tr.optimizer.state_dict()["state"]
    for i, st in want["opt"].items():
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(state[i][k], st[k]), (i, k)


def test_replicated_checkpoint_loads_sharded(shard_runs):
    file = torch.load(os.path.join(shard_runs["rep_root"], "model-1.pt"), weights_only=False)
    for r, got in enumerate(shard_runs["ranks"]):
        loaded = got["loaded"]
        assert loaded["step"] == 1
        for part in ("model", "ema"):
            for k, v in loaded[part].items():
                assert torch.equal(v, file[part][k]), (part, k)
        for i, st in file["opt"]["state"].items():
            for k in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(loaded["opt"][i][k], st[k]), (i, k)
        m = mesh_coords(r, MODEL)[1]
        for name, master, ema in zip(got["stored"], got["loaded_masters"], got["loaded_ema"]):
            full = file["model"][f"model.{name}"]
            full_ema = file["ema"][f"ema_model.model.{name}"]
            if name in got["shard_dims"]:
                d = got["shard_dims"][name]
                full, full_ema = full.chunk(MODEL, d)[m], full_ema.chunk(MODEL, d)[m]
            assert torch.equal(master, full) and torch.equal(ema, full_ema), name


def test_sampling_under_shard_params_is_finite(shard_runs):
    for got in shard_runs["ranks"]:
        imgs = got["sample"]
        assert imgs.shape == (2, S, S, 6) and bool(torch.isfinite(imgs).all())
        assert torch.equal(imgs, shard_runs["ranks"][0]["sample"])
