"""The TMA kernels launched first on a new host thread, against their plain
versions. A kernel that reads through TMA has its entry point encode tensor
maps (a driver call), which needs the device's context current on the
calling thread; a thread that has made no runtime call yet has none, as the
autograd engine's thread may not. Each entry point makes a runtime call
before it encodes a map, so each call below, the first CUDA work of its
thread, succeeds. Inputs are made on the main thread. This file imports no
JAX, so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fresh_thread_cuda.py

Without a CUDA device the tests skip (the kernels have no CPU mode).
Tolerances are the other card tests': dq and dc within 2^-8 x max and cosine
> 0.99999 (the wide products too), lse rtol 2e-5 / atol 1e-5, p within one
bf16 ulp, tower_fwd within 2^-8 x max (its card test's bar)."""

import threading

import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu_torch.ops import softmax_kernel as sk
from two_tower_recommender_model_tpu_torch.ops.tower_fwd import (
    tower_forward,
    tower_forward_reference,
)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _on_fresh_thread(fn):
    """fn() on a new thread that has made no CUDA call before; its result,
    or its exception raised here."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - handed to the caller
            out["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    if "error" in out:
        raise out["error"]
    torch.cuda.synchronize()
    return out["value"]


def _grad_close(got, want, label):
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    assert err <= 2.0 ** -8 * scale, f"{label}: max abs diff {err} > 2^-8 x {scale}"
    cos = torch.nn.functional.cosine_similarity(got.flatten().double(), want.flatten().double(),
                                                dim=0).item()
    assert cos > 0.99999, f"{label}: cosine {cos}"


def _softmax_args(dev, b, d, seed):
    rng = np.random.default_rng(seed)
    q16, c16 = (torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(dev, torch.bfloat16)
                for _ in range(2))
    ids = torch.from_numpy(rng.integers(1, 200, b).astype(np.int32)).to(dev)
    log_q = torch.from_numpy((rng.normal(size=b) * 0.3).astype(np.float32)).to(dev)
    g = torch.from_numpy((rng.normal(size=b) / b).astype(np.float32)).to(dev)
    adj = sk._merged_adj(log_q, b - 64, b, dev)
    args = (q16, c16, adj, ids, ids, 0, 1 / 0.7)
    return args, sk.lse_forward_reference(*args), g


@pytest.mark.cuda
def test_tower_fwd_on_a_fresh_thread(dev):
    rng = np.random.default_rng(0)
    x, w1, w2 = (torch.from_numpy(rng.normal(size=s).astype(np.float32) * f).to(dev, torch.bfloat16)
                 for s, f in (((1024, 128), 1.0), ((128, 128), 0.1), ((128, 64), 0.1)))
    b1, b2 = (torch.from_numpy(rng.normal(size=n).astype(np.float32) * 0.1).to(dev, torch.bfloat16)
              for n in (128, 64))
    got = _on_fresh_thread(lambda: tower_forward(x, w1, b1, w2, b2))
    want = tower_forward_reference(x, w1, b1, w2, b2)
    # the tensor cores sum in another order than cuBLAS: a value may sit one bf16 ulp away
    scale = want.float().abs().max().item()
    assert scale > 0
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=2.0 ** -8 * scale)


@pytest.mark.cuda
def test_wide_forward_on_a_fresh_thread(dev):
    args, want, _ = _softmax_args(dev, 512, 256, seed=1)
    got = _on_fresh_thread(lambda: sk.softmax_lse_fwd(*args))
    torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-5)


@pytest.mark.cuda
def test_p_kernel_on_a_fresh_thread(dev):
    args, lse, g = _softmax_args(dev, 512, 256, seed=2)
    got = _on_fresh_thread(lambda: sk.softmax_lse_p(*args, lse, g, 0, 512))
    want = sk.p_panel_reference(*args, lse, g, 0, 512)
    # within one bf16 ulp (2^-7 of a value at most); ex2.approx flushes below 2^-126
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7, atol=1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["dq", "dc"])
def test_wide_product_on_a_fresh_thread(dev, which):
    args, lse, g = _softmax_args(dev, 512, 256, seed=3)
    q16, c16, inv_t = args[0], args[1], args[6]
    p = sk.p_panel_reference(*args, lse, g, 0, 512)
    wrapper = sk.softmax_lse_dq if which == "dq" else sk.softmax_lse_dc
    out = torch.empty((512, 256), dtype=torch.float32, device=dev)
    got = _on_fresh_thread(lambda: wrapper.product(p, c16 if which == "dq" else q16, out, inv_t))
    want = (sk.dq_product_reference(p, c16, inv_t) if which == "dq" else
            sk.dc_product_reference(p, q16, torch.empty_like(out), inv_t, True, True))
    _grad_close(got, want, f"{which} product")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("which", ["dq", "dc"])
def test_narrow_backward_on_a_fresh_thread(dev, which, d):
    args, lse, g = _softmax_args(dev, 4096, d, seed=4 + d)
    wrapper = sk.softmax_lse_dq if which == "dq" else sk.softmax_lse_dc
    got = _on_fresh_thread(lambda: wrapper(*args, lse, g))
    want = sk.lse_backward_reference(*args, lse, g, need_dq=which == "dq",
                                     need_dc=which == "dc")[0 if which == "dq" else 1]
    _grad_close(got, want, which)
