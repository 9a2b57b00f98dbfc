"""The plain versions of the training kernels against the JAX package.

On the CPU every wrapper of the port runs its kernel's plain version, so
these tests hold the plain versions (and the wrappers' plumbing) to the
JAX functions on numpy-seeded inputs in f32:

- flash attention: the log-sum-exp and ``dq, dk, dv`` against ``jax.grad``
  of ``reference_attention`` and against the TPU kernels
  (``flash_attention_lse`` / ``alibi_flash_attention`` with zero slopes) in
  interpret mode, GQA and MHA;
- RMSNorm backward against ``_build_vjp``'s formula (autodiff of
  ``rmsnorm_reference``);
- AdamW against ``_reference_update`` and ``optax.adamw`` over 5 steps.

Tolerances: 1e-5 against the jnp references (the same f32 arithmetic in
another order), 5e-4 against the Pallas kernels in interpret mode (the
JAX package's own tolerance for them, ``tests/test_ops.py``), 1e-6 for
AdamW.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from shuffle_exchange_tpu.ops.flash_attention import reference_attention as jreference
from shuffle_exchange_tpu_torch import ops

# both ops packages export functions named like their modules
jalibi = importlib.import_module("shuffle_exchange_tpu.ops.alibi_attention")
jadam = importlib.import_module("shuffle_exchange_tpu.ops.fused_adam")
jrms = importlib.import_module("shuffle_exchange_tpu.ops.rmsnorm")
tfa = importlib.import_module("shuffle_exchange_tpu_torch.ops.flash_attention")
trms = importlib.import_module("shuffle_exchange_tpu_torch.ops.rmsnorm")
tadam = importlib.import_module("shuffle_exchange_tpu_torch.ops.fused_adam")


def _qkv(B, T, S, H, KV, Dh, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, T, H, Dh), (B, S, KV, Dh), (B, S, KV, Dh), (B, T, H, Dh))]


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


# (B, T, S, H, KV, Dh, causal, segments)
CASES = [(2, 37, 37, 4, 2, 16, True, False), (2, 33, 33, 4, 4, 16, True, True),
         (1, 20, 50, 6, 2, 8, False, False), (2, 64, 64, 8, 2, 32, True, True)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_flash_lse_and_backward_equal_jax_autodiff(case):
    B, T, S, H, KV, Dh, causal, segments = case
    q, k, v, do = _qkv(B, T, S, H, KV, Dh)
    seg = (np.sort(np.random.default_rng(1).integers(0, 3, size=(B, T)), axis=1).astype(np.int32)
           if segments else None)
    jseg = None if seg is None else jnp.asarray(seg)

    def f(q, k, v):
        return jreference(q, k, v, causal=causal, segment_ids=jseg)

    want_out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = _t(q, k, v, do)
    tseg = None if seg is None else torch.from_numpy(seg)
    out, lse = tfa.flash_attention_lse(tq, tk, tv, causal, tseg)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-5)
    # the wrapper's backward (the plain version of the dq / dkv passes)
    got = tfa.flash_attention_bwd(tq, tk, tv, out, lse, tdo, causal, tseg)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, err_msg=name)
    # autograd through flash_attention on tensors that require grad
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    auto = torch.autograd.grad(tfa.flash_attention(*leaves, causal, tseg), leaves, tdo)
    for g, w, name in zip(auto, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, err_msg=name)
    # lse: the natural-log log-sum-exp of the masked scaled scores
    scores = np.einsum("bthd,bshd->bhts", q * Dh ** -0.5, np.repeat(k, H // KV, axis=2))
    allowed = np.ones((B, 1, T, S), bool)
    if causal:
        allowed &= np.tril(np.ones((T, S), bool), S - T)[None, None]
    if seg is not None:
        allowed &= (seg[:, :, None] == seg[:, None, :])[:, None]
    scores = np.where(allowed, scores, -1e30)
    m = scores.max(-1, keepdims=True)
    want_lse = (m + np.log(np.exp(scores - m).sum(-1, keepdims=True)))[..., 0]
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (B, H, T)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5)


@pytest.mark.parametrize("H,KV", [(4, 2), (2, 2)], ids=["gqa", "mha"])
def test_flash_plain_versions_equal_the_tpu_kernels_in_interpret_mode(H, KV):
    """``flash_attention_lse`` (the ALiBi kernel family at slope 0) and
    ``alibi_flash_attention`` with zero slopes, forward, lse and backward."""
    B, T, Dh = 1, 128, 64
    q, k, v, do = _qkv(B, T, T, H, KV, Dh, seed=3)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    (jout, jlse), vjp = jax.vjp(lambda q, k, v: jalibi.flash_attention_lse(q, k, v, True, True),
                                jq, jk, jv)
    jgrads = vjp((jdo, jnp.zeros_like(jlse)))
    tq, tk, tv, tdo = _t(q, k, v, do)
    out, lse = tfa.flash_attention_lse(tq, tk, tv, True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=2e-4, atol=2e-5)
    got = tfa.flash_attention_bwd(tq, tk, tv, out, lse, tdo, True)
    for g, w, name in zip(got, jgrads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-4, atol=5e-4, err_msg=name)
    zero = jnp.zeros((H,), jnp.float32)
    aout = jalibi.alibi_flash_attention(jq, jk, jv, zero, True, True)
    np.testing.assert_allclose(out.numpy(), np.asarray(aout), rtol=2e-4, atol=2e-5)


def test_flash_backward_refuses_mismatched_operands():
    q, k, v, do = _t(*_qkv(1, 8, 8, 2, 2, 16))
    out, lse = tfa.flash_attention_lse(q, k, v)
    with pytest.raises(ValueError, match="must have q's shape"):
        tfa.flash_attention_bwd(q, k, v, out, lse, do[:, :4])
    with pytest.raises(TypeError, match="dout must be bf16"):
        tfa.check_operands(q.bfloat16(), k.bfloat16(), v.bfloat16(), dout=do)
    with pytest.raises(ValueError, match="dout must be contiguous"):
        tfa.check_operands(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                           dout=do.bfloat16().transpose(1, 2))


@pytest.mark.parametrize("shape", [(7, 32), (2, 5, 48)])
def test_rmsnorm_backward_equals_the_jax_vjp(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    w = (1 + 0.1 * rng.normal(size=shape[-1])).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    _, vjp = jax.vjp(lambda x, w: jrms.rmsnorm_reference(x, w, 1e-5), jnp.asarray(x),
                     jnp.asarray(w))
    want_dx, want_dw = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    tx, tw, tg = _t(x, w, g)
    dx, dw = trms.rmsnorm_backward(tx, tw, tg, 1e-5)
    np.testing.assert_allclose(dx.numpy(), want_dx, atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), want_dw, atol=1e-5)
    # through the wrapper under autograd, with a fused residual
    res = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (tx, tw, res)]
    got = torch.autograd.grad(trms.rmsnorm(leaves[0], leaves[1], 1e-5, residual=leaves[2]),
                              leaves, tg)
    _, vjp = jax.vjp(lambda x, w, r: jrms.rmsnorm_reference(x + r, w, 1e-5), jnp.asarray(x),
                     jnp.asarray(w), jnp.asarray(res.numpy()))
    for a, b in zip(got, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_rmsnorm_backward_casts_to_the_inputs_dtypes():
    x = torch.randn(4, 32, generator=torch.Generator().manual_seed(0)).bfloat16().requires_grad_()
    w = torch.ones(32, dtype=torch.bfloat16, requires_grad=True)
    trms.rmsnorm(x, w).float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.bfloat16
    before = ops.launch_counts()
    assert before["rmsnorm"] == ops.launch_counts()["rmsnorm"]    # no launch on CPU tensors


@pytest.mark.parametrize("wd,step,gscale", [(0.0, 1, 1.0), (0.1, 1, 1.0), (0.1, 1000, 0.37)])
def test_adamw_plain_version_equals_the_jax_reference_update(wd, step, gscale):
    rng = np.random.default_rng(0)
    p, g, m = (rng.normal(size=(5, 33)).astype(np.float32) * s for s in (0.02, 1e-3, 1e-3))
    v = rng.random(size=(5, 33)).astype(np.float32) * 1e-6
    hp = dict(lr=3e-4, b1=0.9, b2=0.999, eps=1e-8, weight_decay=wd)
    want = jadam._reference_update(jnp.asarray(p), jnp.asarray(g * np.float32(gscale)),
                                   jnp.asarray(m), jnp.asarray(v), step=step, **hp)
    tp, tg, tm, tv = _t(p.copy(), g, m.copy(), v.copy())
    got = tadam.reference_update(tp, tg, tm, tv, step=step, grad_scale=gscale, **hp)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)
    tadam.fused_adamw_update(tp, tg, tm, tv, step=step, grad_scale=gscale, **hp)   # in place
    for a, b in zip((tp, tm, tv), want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("clip", [0.0, 0.05], ids=["noclip", "clip"])
def test_fused_adamw_object_follows_optax_adamw_over_5_steps(clip):
    """count, mu and nu under the leaf names, the schedule read at the
    count before the step (``schedule_offset=0``, as ``optax.adamw`` reads
    it), clipping in front."""
    rng = np.random.default_rng(1)
    params = {"a": rng.normal(size=(4, 6)).astype(np.float32),
              "layers.b": rng.normal(size=(3, 5)).astype(np.float32)}
    sched = lambda c: 1e-2 * (1.0 + 0.5 * c)
    tx = optax.adamw(lambda c: 1e-2 * (1.0 + 0.5 * c), b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    if clip:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    port = tadam.FusedAdamW(sched, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                            max_grad_norm=clip, schedule_offset=0)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = port.init(tp)
    assert state.count == 0 and set(state.mu) == set(state.nu) == set(params)
    for i in range(5):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) * 0.1 for k, v in params.items()}
        upd, jstate = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        port.update(tp, {k: torch.from_numpy(g) for k, g in grads.items()}, state)
        assert state.count == i + 1
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7,
                                       err_msg=f"{k} step {i}")


def test_fused_adamw_object_follows_pallas_adamw_over_5_steps():
    """By default the schedule is read where ``pallas_adamw`` reads it: at
    the count after the increment (1 at the first update)."""
    rng = np.random.default_rng(2)
    params = {"a": rng.normal(size=(4, 6)).astype(np.float32),
              "layers.b": rng.normal(size=(3, 5)).astype(np.float32)}
    sched = lambda c: 1e-2 * c / 3.0          # 0 at count 0: the indices cannot be confused
    tx = jadam.pallas_adamw(sched, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    port = tadam.FusedAdamW(sched, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = port.init(tp)
    for i in range(5):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) * 0.1 for k, v in params.items()}
        upd, jstate = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        port.update(tp, {k: torch.from_numpy(g) for k, g in grads.items()}, state)
        assert state.count == int(jstate.count) == i + 1
        for k in params:
            assert i or not np.array_equal(tp[k].numpy(), params[k])    # the first step moves
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7,
                                       err_msg=f"{k} step {i}")


def test_adamw_wrapper_checks_its_operands():
    p = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="one shape"):
        tadam.fused_adamw_update(p, torch.zeros(4), p.clone(), p.clone(), lr=1e-3)
    with pytest.raises(ValueError, match="1-based"):
        tadam.fused_adamw_update(p, p.clone(), p.clone(), p.clone(), lr=1e-3, step=0)
    assert tadam.clip_coefficient(2.0, 1.0) == 0.5 and tadam.clip_coefficient(0.5, 1.0) == 1.0
    assert tadam.clip_coefficient(5.0, 0.0) == 1.0
    assert set(ops.KERNEL_WRAPPERS) >= {"flash_attention_bwd", "fused_adamw"}
