"""Rank functions of ``tests/test_torch_parallel.py``, run by
``parallel.dryrun.run_ranks`` in spawned processes over gloo on the CPU.
This module imports torch and the port only (no JAX): each rank imports it
by name."""

import torch

from multimodal_scene_text_recognition_tpu_torch import api, convert
from multimodal_scene_text_recognition_tpu_torch.config import ModelConfig, TrainConfig
from multimodal_scene_text_recognition_tpu_torch.ops.batchnorm import bn_train
from multimodal_scene_text_recognition_tpu_torch.parallel.mesh import (GroupSum, gather_state,
                                                                        make_mesh, shard_state,
                                                                        split_dims)
from multimodal_scene_text_recognition_tpu_torch.train.steps import (shard_beam_step,
                                                                      shard_eval_step,
                                                                      shard_train_step)


def _numpy(state):
    return {k: v.detach().numpy().copy() for k, v in state.items()}


def train_and_decode(rank, world, device, cfg_kw, train_kw, flat, batch, steps, model_axis,
                     decode=True):
    """``steps`` sharded steps from the bundle ``flat`` on ``batch`` (the
    placed model's state first held to ``shard_state`` of the whole); the
    metrics of each, the whole state after step 1 (gathered); then, with
    ``decode``, the sharded greedy and beam (k=2) ids of fresh models with
    the bundle's weights.  Everything but the ids is rank 0's alone."""
    cfg, tcfg = ModelConfig(**cfg_kw), TrainConfig(**train_kw)
    mesh = make_mesh(world, model_axis)
    full = convert.bundle_to_state_dict(flat)
    trainer = api.get_trainer(None, cfg, tcfg, device=device)
    trainer.model.load_state_dict(full)
    dims = split_dims(trainer.model.state_dict(), mesh.model)
    shard_train_step(trainer, mesh)
    placed = trainer.model.state_dict()
    pieces = shard_state(full, mesh)
    if pieces.keys() != placed.keys() or not all(torch.equal(pieces[k], placed[k].cpu())
                                                  for k in placed):
        raise AssertionError("the placed model's state is not shard_state's pieces")
    metrics, state1 = [], None
    for i in range(steps):
        metrics.append({k: v.item() for k, v in trainer(batch).items()})
        if i == 0:
            state1 = _numpy(gather_state(trainer.model.state_dict(), mesh, dims))
    out = {"metrics": metrics, "state1": state1 if rank == 0 else None,
           "local_shapes": {k: tuple(v.shape) for k, v in trainer.model.state_dict().items()}}
    if decode:
        models = []
        for _ in range(2):
            m = api.get_model(None, cfg, device=device)
            m.load_state_dict(full)
            models.append(m)
        out["ids"] = shard_eval_step(models[0], mesh)[0](batch).numpy()
        out["beam"] = shard_beam_step(models[1], mesh, beam_size=2)[0](batch).numpy()
    return out


def train_cases(rank, world, device, cases):
    """:func:`train_and_decode` of each argument tuple of ``cases``, in one
    process group."""
    return [train_and_decode(rank, world, device, *case) for case in cases]


def batchnorm(rank, world, device, x, dy, weight, bias):
    """Train-mode BatchNorm over this rank's rows of x [B, C, H, W] with
    the data group (all ranks): y, mean, var, dx and the local dgamma,
    dbeta, on the plain path."""
    mesh = make_mesh(world, 1)
    rows = x.shape[0] // world
    xl = torch.from_numpy(x[rank * rows:(rank + 1) * rows]).requires_grad_(True)
    w = torch.from_numpy(weight).requires_grad_(True)
    b = torch.from_numpy(bias).requires_grad_(True)
    y, mean, var = bn_train(xl, w, b, 1e-5, plain=True, reducer=GroupSum(mesh.data_group))
    y.backward(torch.from_numpy(dy[rank * rows:(rank + 1) * rows]))
    return {k: v.detach().numpy() for k, v in dict(y=y, mean=mean, var=var, dx=xl.grad,
                                                   dgamma=w.grad, dbeta=b.grad).items()}
