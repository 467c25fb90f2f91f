"""The port's int8-vs-bf16 GEMM probe (``ops/gemm_probe.py``,
``scripts/probe_int8.py``) against the JAX probe
``scripts/probe_int8_pallas.py``, whose Pallas kernels run here in
interpret mode at the probe's own widths (B=192, E=256, F=2048).

The JAX kernels read the chain's length from the module's ``ITERS``, set
per case.  Interpreted on the CPU, XLA contracts P1's ``acc + a32 * s``
into one fused multiply-add, where the port rounds the product first as the
kernel is written; at one step the sum adds to zero and the two are equal,
from the second step on they part by float32 rounding that feeds back.  The
chain grows about 16-fold a step and overflows after some 32 steps, so
numbers are compared up to 30 steps and the probe's 200 only as all NaN.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from multimodal_scene_text_recognition_tpu_torch.ops import gemm_probe as gp
from multimodal_scene_text_recognition_tpu_torch.scripts import probe_int8

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_probe():
    spec = importlib.util.spec_from_file_location(
        "probe_int8_pallas", ROOT / "scripts" / "probe_int8_pallas.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    return probe


@pytest.fixture(scope="module")
def inputs():
    return gp.probe_inputs(0, device="cpu")


def numpy_preparation(seed=0):
    """The JAX probe's own preparation (probe_int8_pallas.py:60-66)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(gp.B, gp.E)).astype(np.float32)
    w = rng.normal(size=(gp.E, gp.F)).astype(np.float32)
    ws = np.abs(w).max(axis=0) / 127.0
    wq = np.clip(np.round(w / ws), -127, 127).astype(np.int8)
    wbf = np.asarray(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32))
    return x, wq, ws[None, :].astype(np.float32), wbf


def run_jax(probe, monkeypatch, kind, iters, x, *weights):
    """The Pallas kernel ``kind`` of the JAX probe, interpreted, at
    ``iters`` steps (whole-array blocks: the TPU's VMEM specs dropped)."""
    monkeypatch.setattr(probe, "ITERS", iters)
    kern = probe.kern_int8 if kind == "int8" else probe.kern_bf16
    return np.asarray(pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((gp.B, gp.F), jnp.float32),
        interpret=True)(x, *weights))


def jax_args(kind, x, wq, ws, wbf):
    if kind == "int8":
        return x.numpy(), wq.numpy(), ws.numpy()
    return x.numpy(), jnp.asarray(wbf.float().numpy(), jnp.bfloat16)


def port(kind, x, wq, ws, wbf, iters):
    if kind == "int8":
        return gp.int8_chain(x, wq, ws, iters).numpy()
    return gp.bf16_chain(x, wbf, iters).numpy()


def test_probe_inputs_equal_the_probes_preparation(inputs):
    x, wq, ws, wbf = inputs
    want = numpy_preparation(0)
    assert x.dtype == torch.float32 and wq.dtype == torch.int8
    assert ws.dtype == torch.float32 and wbf.dtype == torch.bfloat16
    np.testing.assert_array_equal(x.numpy(), want[0])
    np.testing.assert_array_equal(wq.numpy(), want[1])
    np.testing.assert_array_equal(ws.numpy(), want[2])
    np.testing.assert_array_equal(wbf.float().numpy(), want[3])


def test_tie_input_makes_every_first_quantization_a_tie():
    x = gp.tie_input(0, device="cpu")
    assert x.abs().max().item() == 127.0
    frac = (x - x.floor()).flatten()[1:]
    assert bool((frac == 0.5).all())
    assert bool((x < 0).any()) and bool((x.floor() % 2 == 0).any())


# (kind, steps, limit of max |port - JAX| over max |JAX|; 0 = bit-equal).
# Measured here: P1 0 / 1.0e-7 / 1.2e-7, P2 3.0e-7 / 1.6e-3 / 8.6e-3 at 1
# / 4 / 30 steps.
CASES = [("int8", 1, 0.0), ("int8", 4, 1e-6), ("int8", 30, 1e-6),
         ("bf16", 1, 1e-6), ("bf16", 4, 5e-3), ("bf16", 30, 2e-2)]


@pytest.mark.parametrize("kind,iters,limit", CASES, ids=[f"{k}-{n}" for k, n, _ in CASES])
def test_plain_chain_matches_pallas_kernel(jax_probe, monkeypatch, inputs, kind, iters, limit):
    want = run_jax(jax_probe, monkeypatch, kind, iters, *jax_args(kind, *inputs))
    got = port(kind, *inputs, iters)
    assert got.shape == (gp.B, gp.F) and np.isfinite(want).all() and np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    if limit == 0.0:
        np.testing.assert_array_equal(got, want)
    assert err <= limit, err


@pytest.mark.parametrize("iters", [1, 4])
def test_plain_int8_chain_rounds_ties_as_the_pallas_kernel(jax_probe, monkeypatch, inputs,
                                                          iters):
    """Every first quantization a half-way tie (``tie_input``): half to even
    in both, bit-equal at one step (measured 8.9e-8 at four steps), and
    half away from zero would have given another first step."""
    _, wq, ws, _ = inputs
    x = gp.tie_input(0, device="cpu")
    want = run_jax(jax_probe, monkeypatch, "int8", iters, x.numpy(), wq.numpy(), ws.numpy())
    got = gp.int8_chain(x, wq, ws, iters).numpy()
    if iters == 1:
        np.testing.assert_array_equal(got, want)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    if iters == 1:  # inv is 1.0, so the first step's out is the product times ws
        away = np.clip(np.sign(x.numpy()) * np.floor(np.abs(x.numpy()) + 0.5), -127, 127)
        wrong = (away.astype(np.int64) @ wq.numpy().astype(np.int64)).astype(np.float32) \
            * ws.numpy()
        assert np.abs(wrong - want).max() > 1.0


@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_probe_length_chain_is_all_nan_in_both(jax_probe, monkeypatch, inputs, kind):
    """The probe's own 200 steps overflow float32 and end all NaN, in JAX
    and in the port alike (the NaN-propagating abs-max and clamp in P1)."""
    want = run_jax(jax_probe, monkeypatch, kind, gp.ITERS, *jax_args(kind, *inputs))
    got = port(kind, *inputs, gp.ITERS)
    assert np.isnan(want).all() and np.isnan(got).all()


def test_plain_int8_chain_propagates_a_nan_as_the_pallas_kernel(jax_probe, monkeypatch,
                                                               inputs):
    """One NaN in x makes the abs-max NaN, and jnp.maximum(NaN, 1e-12) keeps
    it: every out is NaN after one step, in JAX and in the port (a floor by
    fmax would quantize with 127e12 and give numbers)."""
    x, wq, ws, _ = inputs
    x = x.clone()
    x[3, 5] = float("nan")
    want = run_jax(jax_probe, monkeypatch, "int8", 1, x.numpy(), wq.numpy(), ws.numpy())
    assert np.isnan(want).all() and np.isnan(gp.int8_chain(x, wq, ws, 1).numpy()).all()


def test_int8_product_is_exact(inputs):
    x, wq, _, _ = inputs
    xq = torch.clamp(torch.round(x * (127.0 / x.abs().max())), -127, 127).to(torch.int8)
    want = xq.numpy().astype(np.int64) @ wq.numpy().astype(np.int64)
    np.testing.assert_array_equal(gp._int_product(xq, wq).numpy(), want)


@pytest.mark.parametrize("argv", [["--device", "cpu", "--iters", "4"],
                                  ["--device", "cpu", "--iters", "4", "--run"]],
                         ids=["check", "run"])
def test_probe_script_runs_on_the_cpu(argv, capsys):
    res = probe_int8.main(argv)
    assert res["p1_differing"] == 0 and res["p2_err"] == 0.0
    out = capsys.readouterr().out
    assert "checked at 4 steps on cpu" in out
    if "--run" in argv:
        assert res["int8_ms"] > 0 and res["bf16_ms"] > 0
        assert "int8:" in out and "TF/s" in out and "host clock" in out


def test_probe_script_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe_int8.main([])


def test_dispatch_takes_plain_on_cpu_and_the_kernel_wrappers_refuse_cpu(inputs):
    x, wq, ws, wbf = inputs
    before = (gp.int8_chain_cuda.launches, gp.bf16_chain_cuda.launches)
    torch.testing.assert_close(gp.int8_chain(x, wq, ws, 2), gp.int8_chain_plain(x, wq, ws, 2),
                               atol=0, rtol=0)
    torch.testing.assert_close(gp.bf16_chain(x, wbf, 2), gp.bf16_chain_plain(x, wbf, 2),
                               atol=0, rtol=0)
    assert (gp.int8_chain_cuda.launches, gp.bf16_chain_cuda.launches) == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        gp.int8_chain_cuda(x, wq, ws, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gp.bf16_chain_cuda(x, wbf, 2)
