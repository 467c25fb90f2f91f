"""The multi-process dry run (JAX counterpart: ``__graft_entry__.py``'s
``dryrun_multichip``) and :func:`run_ranks`, which runs a function on
several local processes joined by ``torch.distributed``.

    python -m multimodal_scene_text_recognition_tpu_torch.parallel.dryrun N [--device cpu]

runs the flagship's train step in float32 over an N-rank mesh (``model``
axis 2 where N is even), holds its first step to the single-process step
within JAX's limits, checks that the loss falls over three steps, then
decodes greedily and by beam search (k=2) over the mesh, where at most 2%
of the id positions may differ from the single process's (JAX's own
limits).  On the card each rank takes one card (NCCL): N cards; on the CPU
the ranks are processes over gloo.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import queue
import shutil
import sys
import tempfile
import traceback
from typing import Any, Callable, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# JAX's dry-run limits (__graft_entry__.py:181, :216, :245)
STEP_ATOL, STEP_RTOL = 1e-4, 1e-5
DECODE_MISMATCH = 0.02


def _rank_main(fn, args, rank, world, backend, device, init_method, results):
    try:
        if device == "cpu":
            torch.set_num_threads(1)
        else:  # the card's context before the wait for the peers, not after it
            torch.cuda.set_device(torch.device(device))
            torch.cuda.init()
            torch.empty(1, device=device)
        dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
        try:
            results.put((rank, True, fn(rank, world, device, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # the parent raises it; a rank must never hang its peers' wait
        results.put((rank, False, traceback.format_exc()))


class Ranks:
    """Ranks started by :func:`start_ranks`: their processes and the queue
    of their results."""

    def __init__(self, procs, results, store_dir: Optional[str]):
        self.procs, self.results, self.store_dir = procs, results, store_dir

    def collect(self, timeout: float = 600.0) -> List[Any]:
        """The ranks' results in rank order; raises, with the failing
        rank's traceback, where a rank raised or the ranks did not all end
        within ``timeout`` seconds.  Every process is ended on return."""
        try:
            got = {}
            while len(got) < len(self.procs):
                try:
                    rank, ok, value = self.results.get(timeout=timeout)
                except queue.Empty:
                    raise TimeoutError(f"{len(self.procs) - len(got)} of {len(self.procs)} "
                                       f"ranks gave no result within {timeout} s") from None
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                got[rank] = value
            for p in self.procs:
                p.join(timeout=60)
            return [got[r] for r in sorted(got)]
        finally:
            self.close()

    def close(self) -> None:
        """End every process still running and remove the store."""
        for p in self.procs:
            if p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join()
        if self.store_dir is not None:
            shutil.rmtree(self.store_dir, ignore_errors=True)


def start_ranks(fn: Callable, args: Sequence[Any], devices: Mapping[int, str], world: int,
                backend: str, init_method: Optional[str] = None) -> Ranks:
    """Start ``fn(rank, world, device, *args)`` in a new process for each
    rank of ``devices`` ({rank: device}; spawned: ``fn`` and ``args`` are
    pickled, ``fn`` by its import path), joined in one process group of
    ``world`` ranks and ``backend`` through the store ``init_method`` (a
    file store in a new temporary directory by default).  Ranks not in
    ``devices`` are the caller's to join.  Returns once each process has
    taken its arguments: a spawned process reads them from a pipe after
    importing the caller's ``__main__``, so ``args`` beyond the pipe's
    buffer (64 KiB on Linux) hold the caller that long."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store_dir = None
    if init_method is None:
        store_dir = tempfile.mkdtemp(prefix="ranks_")
        init_method = f"file://{os.path.join(store_dir, 'store')}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, tuple(args), r, world, backend, d, init_method, results))
             for r, d in sorted(devices.items())]
    ranks = Ranks(procs, results, store_dir)
    try:
        for p in procs:
            p.start()
    except BaseException:
        ranks.close()
        raise
    return ranks


def run_ranks(fn: Callable, args: Sequence[Any], devices: Sequence[str], backend: str,
              timeout: float = 600.0, store_dir: Optional[str] = None) -> List[Any]:
    """``fn(rank, world, device, *args)`` on ``len(devices)`` new processes,
    rank r on ``devices[r]`` (:func:`start_ranks`, the store a file in
    ``store_dir`` where given), and their results in rank order
    (``Ranks.collect``)."""
    init = None if store_dir is None else f"file://{os.path.join(store_dir, 'store')}"
    return start_ranks(fn, args, dict(enumerate(devices)), len(devices), backend,
                       init).collect(timeout)


def example_batch(B: int, cfg, seed: int = 0) -> dict:
    """A seeded batch in the wire format: uint8 crops of bars on a
    background, label rows of random words, overlap ids, no scene objects."""
    from ..charset import AttnCodec

    rng = np.random.default_rng(seed)
    img = np.empty((B, cfg.img_h, cfg.img_w, 1), np.float64)
    for b in range(B):
        bg = rng.uniform(40, 215)
        img[b] = bg
        for x in range(4, cfg.img_w - 8, 8):
            h0, h1 = sorted(rng.integers(4, cfg.img_h - 3, 2))
            img[b, h0:h1 + 2, x:x + rng.integers(2, 5)] = 255 - bg
    img += rng.normal(0, 8, img.shape)
    words = ["".join(rng.choice(list("abcdefghij0123"), rng.integers(1, 9))) for _ in range(B)]
    text, _ = AttnCodec(cfg.chars, cfg.max_text_length).encode(words)
    return {"image": np.clip(img, 0, 255).astype(np.uint8), "text": text,
            "overlap": rng.integers(0, 100, (B, cfg.max_overlap_objs)).astype(np.int32)}


def _dryrun_rank(rank: int, world: int, device: str, cfg, batch_size: int) -> dict:
    from .. import api
    from ..config import TrainConfig
    from ..train.steps import prep_image, shard_beam_step, shard_eval_step, shard_train_step
    from .mesh import make_mesh

    mesh = make_mesh(world, model_axis=2 if world % 2 == 0 else 1)
    batch = example_batch(batch_size, cfg)
    tcfg = TrainConfig(batch_size=batch_size)
    ref_loss = api.get_trainer(None, cfg, tcfg, device=device)(batch)["loss"].item()

    step = shard_train_step(api.get_trainer(None, cfg, tcfg, device=device), mesh)
    losses = [step(batch)["loss"].item() for _ in range(3)]
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite sharded losses {losses}")
    np.testing.assert_allclose(losses[0], ref_loss, atol=STEP_ATOL, rtol=STEP_RTOL)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"sharded loss not decreasing over 3 steps on one batch: {losses}")

    model = api.get_model(None, cfg, device=device)
    image = prep_image(torch.as_tensor(batch["image"], device=device))
    overlap = torch.as_tensor(batch["overlap"], device=device).long()
    with torch.no_grad():
        ref_ids = model(image, overlap).argmax(dim=-1)
        ref_beam = model.beam_decode(image, overlap, 2)[0]
    ids = shard_eval_step(api.get_model(None, cfg, device=device), mesh)[0](batch)
    beam = shard_beam_step(api.get_model(None, cfg, device=device), mesh, beam_size=2)[0](batch)
    mismatch = (ids != ref_ids).float().mean().item()
    beam_mismatch = (beam != ref_beam).float().mean().item()
    for what, m in (("greedy", mismatch), ("beam", beam_mismatch)):
        if m > DECODE_MISMATCH:
            raise AssertionError(f"sharded {what} decode diverges from the single process: "
                                 f"{m:.1%} of positions differ")
    return {"mesh": mesh.shape, "losses": losses, "single_process_loss": ref_loss,
            "greedy_mismatch": mismatch, "beam_mismatch": beam_mismatch}


def dryrun_multichip(n: int, device: str = "cuda", cfg=None, batch_size: Optional[int] = None,
                     timeout: float = 1200.0) -> dict:
    """The flagship's widths in float32 (``cfg``, default the served
    flagship with the fused beam search, in float32) over an ``n``-rank mesh,
    ``batch_size`` crops (default n, as JAX's): see the module's docstring.
    ``device="cuda"`` takes n cards (NCCL) and raises where there are fewer;
    ``"cpu"`` runs n processes over gloo.  Returns rank 0's summary and
    prints JAX's line."""
    from ..config import FLAGSHIP

    if cfg is None:
        cfg = dataclasses.replace(FLAGSHIP, compute_dtype="float32", decode_beam_fused=True)
    if device == "cuda":
        if torch.cuda.device_count() < n:
            raise RuntimeError(f"dryrun_multichip({n}) on the card needs {n} cards, "
                               f"found {torch.cuda.device_count()}")
        devices, backend = [f"cuda:{r}" for r in range(n)], "nccl"
    elif device == "cpu":
        devices, backend = ["cpu"] * n, "gloo"
    else:
        raise ValueError(f"dryrun_multichip: device must be 'cuda' or 'cpu', got {device!r}")
    out = run_ranks(_dryrun_rank, (cfg, batch_size or n), devices, backend, timeout)[0]
    print(f"dryrun_multichip ok: mesh={out['mesh']} loss={out['losses'][0]:.6f} "
          f"(single process {out['single_process_loss']:.6f}) -> {out['losses'][-1]:.6f}; "
          f"greedy/beam positions differing {out['greedy_mismatch']:.4f}/"
          f"{out['beam_mismatch']:.4f}", flush=True)
    return out


if __name__ == "__main__":
    argv = sys.argv[1:]
    dev = "cpu" if "--device" in argv and argv[argv.index("--device") + 1] == "cpu" else "cuda"
    dryrun_multichip(int(argv[0]), device=dev)
