"""The ALiBi flash attention of the PyTorch port against the JAX package.

On the CPU the port's wrappers run their kernels' plain versions, so these
tests hold ``reference_alibi_attention_lse`` (out, lse) and
``reference_alibi_attention_bwd`` (dq, dk, dv, dslope), through the
wrappers, to numpy-seeded f32 inputs of:

- ``jax.vjp`` of the TPU kernels ``alibi_flash_attention(q, k, v, s, True,
  True)`` in interpret mode (B11 forward, B12 dq, B13 dk/dv + dslope),
  within 5e-4, the JAX package's own interpret tolerance;
- ``jax.vjp`` of ``reference_attention(..., alibi_slopes=)``, within 1e-5
  (the same f32 arithmetic in another order), also at a ragged T = 77,
  which the TPU kernel's block gate cannot take.

MHA and GQA (n_rep 2), T == S at 128 and 256, T = 128 < S = 256 (the
bottom-right diagonal), head dims 64 and 128. Then the slopes against JAX
bit for bit, the wrapper's refusals, and the launch-count plumbing with the
kernel gate opened onto the plain versions.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shuffle_exchange_tpu.models import transformer as jtf
from shuffle_exchange_tpu.ops.flash_attention import reference_attention as jreference
from shuffle_exchange_tpu_torch import ops
from shuffle_exchange_tpu_torch.models import alibi_slopes

# both ops packages export functions named like their modules
jalibi = importlib.import_module("shuffle_exchange_tpu.ops.alibi_attention")
tal = importlib.import_module("shuffle_exchange_tpu_torch.ops.alibi_attention")
tfa = importlib.import_module("shuffle_exchange_tpu_torch.ops.flash_attention")


def _inputs(B, T, S, H, KV, Dh, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=s).astype(np.float32)
                   for s in ((B, T, H, Dh), (B, S, KV, Dh), (B, S, KV, Dh), (B, T, H, Dh)))
    # BLOOM-like slopes, scaled so the bias matters at these lengths
    slopes = (alibi_slopes(H) * 0.25).astype(np.float32)
    return q, k, v, slopes, do


def _port(q, k, v, slopes, do):
    """(out, lse, dq, dk, dv, dslope) of the port's wrappers on the CPU."""
    tq, tk, tv, ts, tdo = (torch.from_numpy(a) for a in (q, k, v, slopes, do))
    out, lse = tal.alibi_flash_attention_lse(tq, tk, tv, ts)
    grads = tal.alibi_flash_attention_bwd(tq, tk, tv, ts, out, lse, tdo)
    return [t.numpy() for t in (out, lse, *grads)]


def _jax_vjp(fn, q, k, v, slopes, do):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v, slopes)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


# (B, T, S, H, KV, Dh)
KERNEL_CASES = [(1, 128, 128, 4, 4, 64), (1, 256, 256, 4, 2, 64), (1, 128, 256, 4, 2, 64),
                (1, 128, 128, 2, 2, 128), (1, 128, 256, 4, 4, 128)]


@pytest.mark.parametrize("case", KERNEL_CASES, ids=lambda c: "x".join(map(str, c)))
def test_plain_versions_equal_the_tpu_kernels_in_interpret_mode(case):
    q, k, v, slopes, do = _inputs(*case)
    got = _port(q, k, v, slopes, do)
    want_out, want_grads = _jax_vjp(
        lambda q, k, v, s: jalibi.alibi_flash_attention(q, k, v, s, True, True),
        q, k, v, slopes, do)
    _, want_lse = jalibi._alibi_flash_fwd_impl(*(jnp.asarray(a) for a in (q, k, v, slopes)),
                                               True, True)
    names = ("out", "lse", "dq", "dk", "dv", "dslope")
    for name, g, w in zip(names, got, [want_out, np.asarray(want_lse), *want_grads]):
        assert g.shape == w.shape, name
        # dslope sums ds * j over every pair: relative to its largest |value|
        scale = max(1.0, float(np.abs(w).max())) if name == "dslope" else 1.0
        np.testing.assert_allclose(g / scale, w / scale, atol=5e-4, err_msg=name)


REF_CASES = KERNEL_CASES + [(2, 77, 77, 4, 2, 16), (2, 40, 77, 6, 3, 8)]


@pytest.mark.parametrize("case", REF_CASES, ids=lambda c: "x".join(map(str, c)))
def test_plain_versions_equal_jax_autodiff_of_reference_attention(case):
    q, k, v, slopes, do = _inputs(*case, seed=1)
    got = _port(q, k, v, slopes, do)
    want_out, want_grads = _jax_vjp(
        lambda q, k, v, s: jreference(q, k, v, causal=True, alibi_slopes=s),
        q, k, v, slopes, do)
    for name, g, w in zip(("out", "dq", "dk", "dv"), [got[0], *got[2:5]],
                          [want_out, *want_grads[:3]]):
        np.testing.assert_allclose(g, w, atol=1e-5, err_msg=name)
    scale = max(1.0, float(np.abs(want_grads[3]).max()))
    np.testing.assert_allclose(got[5] / scale, want_grads[3] / scale, atol=1e-5,
                               err_msg="dslope")
    # lse: the log-sum-exp of the biased, bottom-right-masked scores
    B, T, S, H, KV, Dh = case
    kr = np.repeat(k, H // KV, axis=2)
    logits = np.einsum("bthd,bshd->bhts", q * Dh ** -0.5, kr) + slopes[None, :, None, None] * \
        np.arange(S, dtype=np.float32)
    logits = np.where(np.tril(np.ones((T, S), bool), S - T), logits, -1e30)
    m = logits.max(-1, keepdims=True)
    lse = (m + np.log(np.exp(logits - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(got[1], lse, atol=1e-4, rtol=1e-6)


def test_autograd_through_the_cpu_wrapper_equals_the_plain_backward():
    q, k, v, slopes, do = _inputs(2, 40, 64, 4, 2, 16, seed=2)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, slopes)]
    out = ops.alibi_flash_attention(*leaves)
    auto = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    got = _port(q, k, v, slopes, do)
    for name, a, g in zip(("dq", "dk", "dv", "dslope"), auto, got[2:]):
        scale = max(1.0, float(np.abs(g).max()))
        np.testing.assert_allclose(a.numpy() / scale, g / scale, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("H", [8, 12, 16, 20, 32])
def test_slopes_bit_equal_to_jax(H):
    got, want = alibi_slopes(H), np.asarray(jtf.alibi_slopes(H))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_flash_attention_routes_alibi_slopes_to_the_alibi_path():
    q, k, v, slopes, _ = _inputs(1, 20, 33, 4, 2, 16, seed=3)
    tq, tk, tv, ts = (torch.from_numpy(a) for a in (q, k, v, slopes))
    got = tfa.flash_attention(tq, tk, tv, causal=True, alibi_slopes=ts)
    want = tal.reference_alibi_attention_lse(tq, tk, tv, ts)[0]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # numpy slopes are taken too; T != S without slopes stays refused
    torch.testing.assert_close(tfa.flash_attention(tq, tk, tv, alibi_slopes=slopes), want,
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="bottom-right"):
        tfa.flash_attention(tq, tk, tv, causal=True)


@pytest.mark.parametrize("what", ["non-causal", "segment_ids", "s-below-t", "slopes-shape"])
def test_wrapper_refusals(what):
    q, k, v, slopes, _ = _inputs(1, 16, 16, 4, 2, 64)
    tq, tk, tv, ts = (torch.from_numpy(a) for a in (q, k, v, slopes))
    calls = {
        "non-causal": (NotImplementedError, "item 4 \\(d\\)",
                       lambda: tal.alibi_flash_attention(tq, tk, tv, ts, causal=False)),
        "segment_ids": (NotImplementedError, "item 4 \\(d\\)",
                        lambda: tal.alibi_flash_attention(tq, tk, tv, ts,
                                                          segment_ids=torch.zeros(1, 16))),
        "s-below-t": (ValueError, "S >= T",
                      lambda: tal.alibi_flash_attention(tq, tk[:, :8], tv[:, :8], ts)),
        "slopes-shape": (ValueError, "slopes must be",
                         lambda: tal.alibi_flash_attention(tq, tk, tv, ts[:2])),
    }
    err, match, call = calls[what]
    with pytest.raises(err, match=match):
        call()


@pytest.mark.parametrize("Dh", [32, 96, 256])
def test_kernel_operand_check_refuses_unbuilt_head_dims(Dh):
    """On a CUDA tensor the wrapper calls this check before the launch; a
    head_dim the kernels are not built for raises there."""
    q = torch.zeros(1, 8, 4, Dh, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, Dh, dtype=torch.bfloat16)
    s = torch.ones(4)
    with pytest.raises(ValueError, match=f"head_dim {Dh} not built"):
        tal.check_operands(q, k, k, s)
    q, k = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16), torch.zeros(1, 8, 2, 64)
    tal.check_operands(q, k.bfloat16(), k.bfloat16(), s)
    for bad, slopes, err in ((k, s, TypeError), (k.bfloat16().transpose(1, 2), s, ValueError),
                             (k.bfloat16(), s.double(), TypeError)):
        with pytest.raises(err):
            tal.check_operands(q, bad, bad, slopes)


def test_wrapper_raises_on_a_meta_tensor():
    q = torch.zeros(1, 4, 2, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tal.alibi_flash_attention(q, q, q, torch.ones(2, device="meta"))


def test_launch_counts_with_the_gate_open_onto_the_plain_versions(monkeypatch):
    """With the kernel gate open, a call that requires grad goes through the
    autograd function (forward with lse, then the backward with a dslope
    only when the slopes require grad); a no-grad call takes the forward
    without lse. Each wrapper counts one launch per call."""
    calls = []

    def launch(q, k, v, slopes, want_lse):
        calls.append(("fwd", want_lse))
        out, lse = tal.reference_alibi_attention_lse(q, k, v, slopes)
        return out, (lse if want_lse else None)

    def launch_bwd(q, k, v, slopes, out, lse, dout, need_dslope):
        calls.append(("bwd", need_dslope))
        return tal.reference_alibi_attention_bwd(q, k, v, slopes, out, lse, dout,
                                                 need_dslope=need_dslope)

    monkeypatch.setattr(tal, "use_kernel", lambda t: True)
    monkeypatch.setattr(tal, "_launch", launch)
    monkeypatch.setattr(tal, "_launch_bwd", launch_bwd)
    monkeypatch.setattr(tal.alibi_flash_attention, "launches", 0)
    monkeypatch.setattr(tal.alibi_flash_attention_bwd, "launches", 0)
    q, k, v, slopes, do = (torch.from_numpy(a) for a in _inputs(1, 6, 9, 4, 2, 8))
    q.requires_grad_(True)
    out = tal.alibi_flash_attention(q, k, v, slopes)
    out.backward(do)
    assert calls == [("fwd", True), ("bwd", False)] and q.grad is not None
    s = slopes.clone().requires_grad_(True)
    tal.alibi_flash_attention(q, k, v, s).backward(do)
    assert calls[2:] == [("fwd", True), ("bwd", True)] and s.grad.shape == (4,)
    with torch.no_grad():
        tal.alibi_flash_attention(q, k, v, slopes)
    assert calls[4:] == [("fwd", False)]
    assert (tal.alibi_flash_attention.launches, tal.alibi_flash_attention_bwd.launches) == (3, 2)
    assert ops.launch_counts()["alibi_flash_attention"] == 3
    assert {"alibi_flash_attention", "alibi_flash_attention_bwd"} <= set(ops.KERNEL_WRAPPERS)
