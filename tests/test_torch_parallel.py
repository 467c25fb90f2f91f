"""The multi-device slice of the PyTorch port on the CPU: the (data, model)
mesh over ``torch.distributed`` against the JAX package's mesh on its eight
virtual devices (``tests/conftest.py``).  The port's ranks are processes
spawned by ``parallel.dryrun.run_ranks`` (one torch thread each, gloo, a
file store under ``tmp_path``); their functions are in
``tests/torch_parallel_workers.py``."""

import dataclasses
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from multimodal_scene_text_recognition_tpu.core import config as jconfig
from multimodal_scene_text_recognition_tpu.models.model import build_model
from multimodal_scene_text_recognition_tpu.parallel import mesh as jmesh
from multimodal_scene_text_recognition_tpu.train.state import TrainState
from multimodal_scene_text_recognition_tpu.train.state import make_optimizer as j_make_optimizer
from multimodal_scene_text_recognition_tpu.train.steps import make_train_step
from multimodal_scene_text_recognition_tpu.train.steps import shard_beam_step as j_shard_beam_step
from multimodal_scene_text_recognition_tpu.train.steps import shard_eval_step as j_shard_eval_step
from multimodal_scene_text_recognition_tpu.train.steps import (
    shard_train_step as j_shard_train_step,
)
from multimodal_scene_text_recognition_tpu_torch import api, convert
from multimodal_scene_text_recognition_tpu_torch.config import (Config, ModelConfig, TrainConfig,
                                                                apply_overrides)
from multimodal_scene_text_recognition_tpu_torch.models.layers import BatchRows, uniform
from multimodal_scene_text_recognition_tpu_torch.models.model import SceneTextModel
from multimodal_scene_text_recognition_tpu_torch.ops.batchnorm import bn_train
from multimodal_scene_text_recognition_tpu_torch.parallel import mesh, tensor
from multimodal_scene_text_recognition_tpu_torch.parallel.dryrun import dryrun_multichip, run_ranks
from multimodal_scene_text_recognition_tpu_torch.train.steps import prep_image, token_mask
from test_torch_train import _flat, make_batch, random_bundle, unflatten
import torch_parallel_workers as workers
import torch_threads

torch_threads.limit()

# JAX's TINY (tests/test_train.py) with ff_dim 1024, so that the rule
# splits the FF pairs as well as the semantic table [2000, E], and without
# TPS where gradient norms are compared (TPS_NORM_RTOL)
TINY_TP = dict(enc_layers=1, dec_layers=1, ff_dim=1024, hidden_dim=64, embed_dim=32,
               lstm_hidden=32, num_heads=4, compute_dtype="float32", dropout=0.0,
               use_tps=False)
# JAX's own limits for the sharded step (tests/test_train.py:239-243): the
# loss within rel 1e-5, parameters within 5e-4 (Adam's first update is the
# sign of a near-zero gradient, which rounding can flip: up to 2 lr apart)
LOSS_RTOL, PARAM_ATOL = 1e-5, 5e-4
# the gradient norm against JAX's, without TPS: 6e-5 apart (measured); the
# backbone's gradients differ by ReLU flips between the two packages'
# forwards
JAX_NORM_RTOL = 1e-3
# With TPS at these random weights the loc-net's gradient dominates a norm
# of ~200, and the warp's gradient jumps where a sampling point crosses a
# pixel: rounding-level changes move the norm by ~1%.  JAX's own sharded
# step is 0.73% off its single-process step there, and the port's 0.57%
# off its own; the loss and the updated parameters stay within their limits
TPS_NORM_RTOL = 2e-2
CPU4 = ["cpu"] * 4


def _port_state(tree, collection="params"):
    return convert.bundle_to_state_dict(
        {f"{collection}.{k}": np.asarray(v) for k, v in _flat(tree).items()})


def _jax_leaves(cfg):
    """{bundle key: (JAX shape, PartitionSpec axes)} of ``cfg``'s params."""
    model = build_model(cfg)
    B = 2
    args = (jnp.zeros((B, cfg.img_h, cfg.img_w, 1)),
            jnp.zeros((B, cfg.max_text_length + 1), jnp.int32),
            jnp.zeros((B, cfg.max_overlap_objs), jnp.int32),
            jnp.zeros((B, cfg.max_scene_objs), jnp.int32), jnp.zeros((B, cfg.max_scene_objs)))
    v = jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0),
                                           "dropout": jax.random.PRNGKey(1)}, *args, train=True))
    return v["params"]


# --- the split rule, configuration, initialisation ---------------------------


@pytest.mark.parametrize("model_size", [2, 4])
def test_split_rule_matches_jax_leaf_by_leaf(model_size):
    """``mesh.split_dims`` on the flagship's port tensors names, leaf by
    leaf, the split of JAX's ``param_shardings`` for the JAX leaf each
    carries (a column split of a transposed kernel is the port tensor's
    dimension 0)."""
    params = _jax_leaves(jconfig.ModelConfig(compute_dtype="float32"))
    shardings = jmesh.param_shardings(jmesh.make_mesh(8, model_axis=model_size), params)
    jspec = {f"params.{k}": tuple(s.spec) for k, s in _flat(shardings).items()}
    jshape = {f"params.{k}": v.shape for k, v in _flat(params).items()}
    with torch.device("meta"):
        sd = SceneTextModel(ModelConfig(compute_dtype="float32")).state_dict()
    dims = mesh.split_dims(sd, model_size)
    seen, split = set(), 0
    for name, t in sd.items():
        key, transposed = convert.bundle_key(name, t)
        if key.startswith("batch_stats."):
            assert name not in dims
            continue
        seen.add(key)
        if t.dim() == 2 and transposed:
            assert tuple(reversed(t.shape)) == jshape[key], name
        elif t.dim() != 4:  # a conv kernel's layouts differ, and no rule splits it
            assert tuple(t.shape) == jshape[key], name
        spec = jspec[key]
        want = None
        if "model" in spec:
            jdim = spec.index("model")
            want = 1 - jdim if transposed else jdim
            split += 1
        assert dims.get(name) == want, (name, spec)
    assert seen == set(jspec)
    assert split == 31  # 12 encoder FF, 6 w_qkv, 12 decoder FF, the semantic table


def test_init_distributed_single_process_noop(monkeypatch):
    """As JAX's (tests/test_train.py:365): safe to call from every entry
    point."""
    for k in ("JAX_COORDINATOR", "NPROC", "PROC_ID", "MSTR_MULTIHOST"):
        monkeypatch.delenv(k, raising=False)
    assert mesh.init_distributed() == 1
    assert mesh.init_distributed(num_processes=1) == 1
    assert not torch.distributed.is_initialized()


def test_parallel_overrides_match_jax():
    items = ["parallel.model_axis=2", "parallel.data_axis=4", "parallel.remat=yes"]
    assert dataclasses.asdict(Config().parallel) == dataclasses.asdict(jconfig.Config().parallel)
    got = apply_overrides(Config(), items).parallel
    want = jconfig.apply_overrides(jconfig.Config(), items).parallel
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.data_axis, got.model_axis, got.remat) == (4, 2, True)


@pytest.mark.parametrize("item", ["parallel.model_axis=2", "parallel.data_axis=4",
                                  "parallel.remat=yes"])
def test_parallel_layout_refused_where_one_process_runs(item, tmp_path):
    """What takes a whole Config runs one process's step: the command
    line, ``train/loop.train`` and ``api`` raise on a mesh layout rather
    than ignore it, before loading data or touching the model."""
    from multimodal_scene_text_recognition_tpu_torch import cli
    from multimodal_scene_text_recognition_tpu_torch.train import loop
    from test_torch_cli import SETS

    cfg = apply_overrides(Config(), [item])
    for call in (lambda: cli.main(["validate"] + SETS + ["--set", item], device="cpu"),
                 lambda: cli.main(["recognize", str(tmp_path), "--set", item], device="cpu"),
                 lambda: loop.train(cfg, None, [], []),
                 lambda: api.validate(types.SimpleNamespace(cfg=cfg.model), cfg=cfg)):
        with pytest.raises(ValueError, match="one process's step"):
            call()


def _mesh_without_groups(data, model):
    return mesh.Mesh(data=data, model=model, rank=0, data_group=None, model_group=None)


def test_bilstm_refused_under_model_axis():
    """A cuDNN LSTM cannot be split by columns: placing BiLSTM-Attn (gates
    4 x 256 = 1024 wide) over a model axis of 2 raises before any change;
    with model_axis 1 nothing is split."""
    with torch.device("meta"):
        model = SceneTextModel(ModelConfig(encoder="lstm", decoder="lstm"))
    names = [n for n, _ in model.named_parameters()]
    with pytest.raises(ValueError, match="cuDNN LSTM"):
        tensor.parallelize(model, _mesh_without_groups(1, 2))
    assert [n for n, _ in model.named_parameters()] == names
    assert mesh.split_dims(dict(model.named_parameters()), 1) == {}


def test_int8_encoder_refused_under_model_axis():
    """The int8 encoder quantizes whole weights: serving it over a model
    axis of 2 raises before placing anything."""
    from multimodal_scene_text_recognition_tpu_torch.train.steps import shard_eval_step

    with torch.device("meta"):
        model = SceneTextModel(ModelConfig(encoder_int8=True))
    with pytest.raises(ValueError, match="int8 encoder"):
        shard_eval_step(model, _mesh_without_groups(1, 2))


def test_indivisible_batch_raises():
    batch = {"image": np.zeros((5, 2)), "overlap": np.zeros((5, 3))}
    with pytest.raises(ValueError, match="not divisible"):
        mesh.shard_batch(batch, _mesh_without_groups(2, 1))
    assert mesh.shard_batch(batch, _mesh_without_groups(1, 1))["image"].shape == (5, 2)


def test_batch_rows_draw_the_single_process_rows():
    """A rank's draws are its rows (and columns) of one process's draws."""
    whole = torch.rand((8, 3, 6), generator=torch.Generator().manual_seed(5))
    for rank in range(4):
        g = torch.Generator().manual_seed(5)
        got = uniform((2, 3, 3), BatchRows(g, 2 * rank, 8), "cpu", columns=(3 * (rank % 2), 6))
        want = whole[2 * rank:2 * rank + 2, :, 3 * (rank % 2):3 * (rank % 2) + 3]
        assert torch.equal(got, want)


# --- cross-rank BatchNorm ----------------------------------------------------


def test_cross_rank_batchnorm_matches_one_process(tmp_path):
    """Two ranks, each with half the batch, against one process on the
    whole: y, the statistics and dx within rel 1e-5 of their scale (f32,
    sums in another order); the ranks' local dgamma and dbeta sum to the
    whole batch's."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((6, 5, 3, 4)) * 2 + 1).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(5)).astype(np.float32)
    b = (0.1 * rng.standard_normal(5)).astype(np.float32)
    got = run_ranks(workers.batchnorm, (x, dy, w, b), ["cpu"] * 2, "gloo", store_dir=tmp_path)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt, bt = torch.from_numpy(w).requires_grad_(True), torch.from_numpy(b).requires_grad_(True)
    y, mean, var = bn_train(xt, wt, bt, 1e-5, plain=True)
    y.backward(torch.from_numpy(dy))

    def close(a, want):
        want = want.detach().numpy()
        assert np.abs(a - want).max() <= 1e-5 * np.abs(want).max()

    close(np.concatenate([r["y"] for r in got]), y)
    close(np.concatenate([r["dx"] for r in got]), xt.grad)
    for r in got:
        close(r["mean"], mean)
        close(r["var"], var)
    close(got[0]["dgamma"] + got[1]["dgamma"], wt.grad)
    close(got[0]["dbeta"] + got[1]["dbeta"], bt.grad)


# --- the sharded steps against JAX's and the single process ------------------


def _single_process(cfg, tcfg, flat, batch, steps):
    trainer = api.get_trainer(None, cfg, tcfg, device="cpu")
    trainer.model.load_state_dict(convert.bundle_to_state_dict(flat))
    metrics, state1 = [], None
    for i in range(steps):
        metrics.append({k: v.item() for k, v in trainer(batch).items()})
        if i == 0:
            state1 = {k: v.detach().numpy().copy() for k, v in trainer.model.state_dict().items()}
    return metrics, state1


def _single_ids(cfg, flat, batch):
    model = api.get_model(None, cfg, device="cpu")
    model.load_state_dict(convert.bundle_to_state_dict(flat))
    image = prep_image(torch.as_tensor(batch["image"]))
    kw = dict(scene=torch.as_tensor(batch["scene"]).long(), ious=torch.as_tensor(batch["ious"]))
    overlap = torch.as_tensor(batch["overlap"]).long()
    with torch.no_grad():
        return (model(image, overlap, **kw).argmax(-1).numpy(),
                model.beam_decode(image, overlap, 2, **kw)[0].numpy())


def _params_close(got, want, atol=PARAM_ATOL):
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=atol, err_msg=k)


def test_sharded_step_matches_jax_shard_train_step(tmp_path):
    """Four ranks (data 2 x model 2: the FF pairs, the semantic table split)
    against JAX's ``shard_train_step`` on ``make_mesh(4, model_axis=2)`` from
    the same weights and batch: step 1's loss (rel 1e-5), gradient norm
    (JAX_NORM_RTOL), every updated parameter (atol 5e-4) and running
    statistic; every rank's metrics equal; the split entries are halves;
    the loss falls over 3 steps.  Then the sharded greedy and beam (k=2)
    ids equal the single process's and JAX's ``shard_eval_step`` and
    ``shard_beam_step`` ids."""
    cfg_kw = dict(TINY_TP, decode_fused=True)
    cfg = ModelConfig(**cfg_kw)
    flat = random_bundle(cfg, 7)
    batch = make_batch(8, 3)
    ranks = run_ranks(workers.train_and_decode, (cfg_kw, {}, flat, batch, 3, 2), CPU4, "gloo",
                      store_dir=tmp_path)

    jm = build_model(jconfig.ModelConfig(**TINY_TP))
    variables = unflatten(flat)
    tx = j_make_optimizer(jconfig.TrainConfig())
    state = TrainState(step=0, params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))
    jm_mesh = jmesh.make_mesh(4, model_axis=2)
    step, placed = j_shard_train_step(make_train_step(jm, tx, donate=False, jit_compile=False),
                                      jm_mesh, state)
    jb = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                        NamedSharding(jm_mesh, P("data")))
    new, m = step(placed, jb, jax.random.PRNGKey(0))
    # the train step donated its state: the decodes place fresh copies
    eval_fn, evars = j_shard_eval_step(jm, jm_mesh, unflatten(flat))
    beam_fn, bvars = j_shard_beam_step(jm, jm_mesh, unflatten(flat), beam_size=2)
    jids, jbeam = np.asarray(eval_fn(evars, jb)), np.asarray(beam_fn(bvars, jb))

    got = ranks[0]["metrics"]
    assert all(r["metrics"] == got for r in ranks)
    np.testing.assert_allclose(got[0]["loss"], float(m["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(got[0]["token_acc"], float(m["token_acc"]), rtol=1e-6)
    np.testing.assert_allclose(got[0]["grad_norm"], float(m["grad_norm"]), rtol=JAX_NORM_RTOL)
    assert got[2]["loss"] < got[0]["loss"]
    state1 = ranks[0]["state1"]
    _params_close(state1, {k: v.numpy() for k, v in _port_state(jax.device_get(new.params)).items()})
    stats = _port_state(jax.device_get(new.batch_stats), "batch_stats")
    for k, v in stats.items():
        np.testing.assert_allclose(state1[k], v.numpy(), rtol=1e-4, atol=1e-5, err_msg=k)
    halves = {k: s for k, s in ranks[0]["local_shapes"].items() if s != state1[k].shape}
    assert len(halves) == 5 and all(np.prod(s) * 2 == state1[k].size for k, s in halves.items())

    ids, beam = _single_ids(cfg, flat, batch)
    for r in ranks:
        np.testing.assert_array_equal(r["ids"], ids)
        np.testing.assert_array_equal(r["beam"], beam)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(beam, jbeam)


TRAPS = ("dropout", "counts_pad", "tps")


def _trap_config(trap):
    cfg_kw, train_kw = dict(TINY_TP, decode_fused=True), {}
    if trap in ("dropout", "tps"):
        cfg_kw["dropout"] = 0.1
    if trap in ("counts_pad", "tps"):
        train_kw["loss_counts_pad"] = False
    cfg_kw["use_tps"] = trap == "tps"
    return cfg_kw, train_kw


@pytest.fixture(scope="module")
def trap_runs(tmp_path_factory):
    """Two sharded steps of each trap's configuration, all in one spawn of
    four ranks: {trap: (rank results, bundle)}."""
    batch = make_batch(8, 3)
    cases, flats = [], {}
    for trap in TRAPS:
        cfg_kw, train_kw = _trap_config(trap)
        flats[trap] = random_bundle(ModelConfig(**cfg_kw), 7)
        cases.append((cfg_kw, train_kw, flats[trap], batch, 2, 2, False))
    ranks = run_ranks(workers.train_cases, (cases,), CPU4, "gloo",
                      store_dir=tmp_path_factory.mktemp("traps"))
    return {trap: ([r[i] for r in ranks], flats[trap]) for i, trap in enumerate(TRAPS)}


@pytest.mark.parametrize("trap", TRAPS)
def test_sharded_step_traps_match_single_process(trap, trap_runs):
    """Four ranks (data 2 x model 2) against the port's single-process step
    on the whole batch, two steps: with dropout 0.1 (each rank's masks are
    its rows, and in the split FF hidden its columns, of the single
    process's), and with ``loss_counts_pad=False`` on data ranks whose
    token counts differ (the loss is divided by the whole batch's count,
    not averaged over the ranks); and both with TPS, whose warp (K2 on the
    card) each rank runs on its rows.  Step 1: loss rel 1e-5, gradient norm
    rel 1e-4 (measured <= 1.2e-5: the sums over ranks take another order;
    TPS_NORM_RTOL with TPS), parameters atol 5e-4 (measured 2.0e-4, twice
    the learning rate: Adam's first update is a near-zero gradient's sign).
    Step 2's loss rel 1e-5 without TPS (measured <= 3.8e-6); with TPS the
    two runs part after the first update (norms 188 and 340 at step 2), as
    the chip check's kernel and plain runs do (chip_smoke.TRAIN_NORM_TOL)."""
    cfg_kw, train_kw = _trap_config(trap)
    batch = make_batch(8, 3)
    targets = torch.as_tensor(batch["text"])[:, 1:]
    counts = [int(token_mask(targets[h * 4:(h + 1) * 4], False).sum()) for h in (0, 1)]
    assert counts == [25, 17]  # the data ranks count different tokens
    ranks, flat = trap_runs[trap]
    want, state1 = _single_process(ModelConfig(**cfg_kw), TrainConfig(**train_kw), flat, batch, 2)
    (g, g2), (w, w2) = ranks[0]["metrics"], want
    np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                               rtol=TPS_NORM_RTOL if trap == "tps" else 1e-4)
    assert g["token_acc"] == w["token_acc"]
    _params_close(ranks[0]["state1"], state1)
    if trap != "tps":
        np.testing.assert_allclose(g2["loss"], w2["loss"], rtol=LOSS_RTOL)


def test_dryrun_multichip_on_cpu_ranks():
    """The dry run (JAX ``dryrun_multichip``) at TINY_TP's widths over four
    gloo ranks: step 1 within JAX's limits, the loss falling, greedy and
    beam ids within 2%."""
    cfg = ModelConfig(**dict(TINY_TP, use_tps=True), decode_fused=True)
    out = dryrun_multichip(4, "cpu", cfg=cfg, batch_size=8)
    assert out["mesh"] == {"data": 2, "model": 2}
    assert out["losses"][2] < out["losses"][0]
    assert out["greedy_mismatch"] <= 0.02 and out["beam_mismatch"] <= 0.02


def test_cli_validate_in_one_process_prints_as_before(monkeypatch, capsys):
    """Every verb calls ``init_distributed``: with ``NPROC=1`` (one process
    asked for) ``validate`` prints what it prints with no environment, and
    no ``distributed`` line."""
    from multimodal_scene_text_recognition_tpu_torch import cli
    from test_torch_cli import SETS

    outs = []
    for env in ({}, {"NPROC": "1", "PROC_ID": "0"}):
        for k in ("JAX_COORDINATOR", "NPROC", "PROC_ID", "MSTR_MULTIHOST"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert cli.main(["validate"] + SETS, device="cpu") == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "val accuracy" in outs[1] and "distributed" not in outs[1]
