"""Probe: is an int8 x int8 -> int32 product inside a kernel faster than a
bf16 one with float32 sums, on this card?  (JAX counterpart:
scripts/probe_int8_pallas.py.)

    python -m multimodal_scene_text_recognition_tpu_torch.scripts.probe_int8 \
        [--run] [--iters N] [--device cuda|cpu]

Without ``--run`` it builds the two chain kernels (P1 int8, P2 bf16;
``ops/gemm_probe.py``) and checks each against its plain version at
``CHECK_ITERS`` steps: P1 bit for bit, P2 within ``gp.BF16_CHAIN_TOL``.
With ``--run`` it also times each chain of ``--iters`` steps (default 200):
one warm call, then 10 calls by CUDA events, and prints the rate
``2 * B * E * F * iters`` over the time.  It runs on the card and raises
without one unless ``--device cpu`` is given; on the CPU it runs the plain
versions and times them by the host's clock.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

from ..ops import gemm_probe as gp

CHECK_ITERS = 4
TIMED_CALLS = 10


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]


def check(x, wq, ws, wbf, iters: int = CHECK_ITERS) -> dict:
    """Each chain against its plain version at ``iters`` steps: P1's
    number of differing elements (it must be 0), P2's max |diff| over
    max |plain| (within ``gp.BF16_CHAIN_TOL[iters]`` where that is set).
    Raises if either is out of its limit."""
    p1 = gp.int8_chain(x, wq, ws, iters)
    p1_ref = gp.int8_chain_plain(x, wq, ws, iters)
    p2 = gp.bf16_chain(x, wbf, iters)
    p2_ref = gp.bf16_chain_plain(x, wbf, iters)
    res = {"p1_differing": int((p1 != p1_ref).sum()),
           "p2_err": ((p2 - p2_ref).abs().max() / p2_ref.abs().max()).item()}
    limit = gp.BF16_CHAIN_TOL.get(iters)
    if res["p1_differing"] or (limit is not None and not res["p2_err"] <= limit):
        raise AssertionError(f"a chain kernel disagrees with its plain version at {iters} "
                             f"steps: {res} (P1 must be bit-equal, P2 within {limit})")
    return res


def time_call(fn, device: torch.device) -> float:
    """Milliseconds per call: one warm call, then TIMED_CALLS calls, by
    CUDA events on the card and by the host's clock on the CPU."""
    fn()
    if device.type == "cpu":
        t0 = time.perf_counter()
        for _ in range(TIMED_CALLS):
            fn()
        return (time.perf_counter() - t0) * 1e3 / TIMED_CALLS
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(TIMED_CALLS):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / TIMED_CALLS


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--run", action="store_true", help="time the chains, not only check them")
    p.add_argument("--iters", type=int, default=gp.ITERS, help="steps of a timed chain")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("probe_int8: no CUDA device is available "
                           "(pass --device cpu to run the plain versions on the CPU)")
    if device.type == "cuda":
        print(card_line(), flush=True)
    x, wq, ws, wbf = gp.probe_inputs(0, device)
    res = check(x, wq, ws, wbf)
    print(f"checked at {CHECK_ITERS} steps on {args.device}: int8 chain "
          f"{res['p1_differing']} elements differ from its plain version, bf16 chain "
          f"max |diff| {res['p2_err']:.3e} of max |acc|", flush=True)
    if not args.run:
        return res
    ops = 2 * gp.B * gp.E * gp.F * args.iters
    clock = "CUDA events" if device.type == "cuda" else "host clock, plain version"
    for name, fn in (("bf16", lambda: gp.bf16_chain(x, wbf, args.iters)),
                     ("int8", lambda: gp.int8_chain(x, wq, ws, args.iters))):
        ms = time_call(fn, device)
        res[f"{name}_ms"], res[f"{name}_tf_s"] = ms, ops / (ms * 1e-3) / 1e12
        print(f"{name}: {ms:.2f} ms/call -> {res[f'{name}_tf_s']:.1f} TF/s "
              f"({args.iters} steps, {clock})", flush=True)
    return res


if __name__ == "__main__":
    main()
