"""MoE training in the PyTorch port against the JAX package, on the CPU.

On inputs made with numpy from a seed (the grouped-GEMM wrappers take
their plain versions for CPU tensors):

- The grouped GEMM's backward: the plain dx and dw against ``jax.grad``
  through the JAX ``grouped_matmul`` (``ragged_dot``) in f32, to 1e-5 of
  each result's largest |value|, in four group patterns and with rows past
  the groups' sum; and against the VJP of megablox ``gmm`` itself, run in
  interpret mode, at 128-aligned K and F. Autograd through
  ``grouped_matmul`` lands on the same two functions.
- ``moe_layer``'s output, aux loss and gradients (x, the router, every
  expert leaf, the expert biases) against ``jax.grad`` of the JAX
  ``moe_layer`` for "capacity" (with drops), "capacity_einsum" and
  "ragged", to 1e-5.
- ``tiny_moe``'s loss and every gradient leaf against
  ``jax.grad(model.loss)`` to 1e-4 of each leaf's largest |value|, under
  remat "none" and "nothing_saveable", with and without the shared
  expert, for the three impls.
- 5-step trajectories and the final master and Adam moments against the
  JAX engine (f32 1e-4; bf16 2e-2 on the loss and 5e-2 of each leaf's
  largest |value|, as ``tests/test_torch_train_engine.py`` holds the dense
  model). The JAX engine runs on the 8-device virtual mesh; its step-1
  loss is first held to ``model.loss`` over the global batch, so both
  engines compute one function (capacity and aux loss over all tokens).
- The launch counters with the kernel gate opened onto the plain
  versions: a full-remat step launches ``grouped_matmul`` 3·L·2 times and
  each backward kernel 3·L times.
- Refusals: interleaved dense and MoE layers, gate noise, a quantized
  expert stack under autograd.

The CUDA kernels run only on the card, where ``chip_smoke.py`` phase 2h
holds them against these plain versions.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shuffle_exchange_tpu as jsxt
import shuffle_exchange_tpu_torch as sxt
from shuffle_exchange_tpu.models import Transformer as JTransformer
from shuffle_exchange_tpu_torch.models import (Transformer, load_train_state, params_from_numpy,
                                               train_state_to_numpy)

jl = importlib.import_module("shuffle_exchange_tpu.moe.layer")
jgg = importlib.import_module("shuffle_exchange_tpu.ops.grouped_gemm")
jtf = importlib.import_module("shuffle_exchange_tpu.models.transformer")
tg = importlib.import_module("shuffle_exchange_tpu_torch.moe.gating")
tl = importlib.import_module("shuffle_exchange_tpu_torch.moe.layer")
tgg = importlib.import_module("shuffle_exchange_tpu_torch.ops.grouped_gemm")
tqm = importlib.import_module("shuffle_exchange_tpu_torch.ops.quant_matmul")
ttf = importlib.import_module("shuffle_exchange_tpu_torch.models.transformer")

T = torch.from_numpy
MOE = dict(vocab=97, d=32, layers=2, heads=4, seq=32, experts=4, n_kv_heads=2)
IMPLS = ("capacity", "capacity_einsum", "ragged")
PATTERNS = ("balanced", "one_expert", "empty_ends", "ragged", "past_sum")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _close(got, want, rel, what=""):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(got, np.float32) / scale, want / scale, atol=rel,
                               err_msg=what)


def _sizes(pattern, N, E, rng):
    """Group sizes [E]: the four patterns of chip_smoke's phase 2f summing
    to N, and "past_sum", whose sizes leave the last rows to no group."""
    if pattern == "balanced":
        s = np.full(E, N // E)
        s[:N % E] += 1
    elif pattern == "one_expert":
        s = np.zeros(E, np.int64)
        s[1] = N
    elif pattern == "empty_ends":
        s = np.zeros(E, np.int64)
        s[1:E - 1] = rng.multinomial(N, np.full(E - 2, 1 / (E - 2)))
    elif pattern == "ragged":
        s = rng.multinomial(N, rng.dirichlet(np.ones(E)))
    else:
        s = rng.multinomial(N - 7, np.full(E, 1 / E))
    return s.astype(np.int32)


# ---------------------------------------------------------------------------
# The grouped GEMM's backward
# ---------------------------------------------------------------------------


def _jax_vjp(fn, x, w, sizes, dout):
    out, vjp = jax.vjp(lambda a, b: fn(a, b, jnp.asarray(sizes)), jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(dout))
    return np.asarray(out), np.asarray(dx), np.asarray(dw)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_plain_backward_equals_the_ragged_dot_gradient(pattern):
    rng = np.random.default_rng(5)
    N, K, F, E = 45, 24, 40, 5
    x = rng.standard_normal((N, K)).astype(np.float32)
    w = rng.standard_normal((E, K, F)).astype(np.float32)
    dout = rng.standard_normal((N, F)).astype(np.float32)
    sizes = _sizes(pattern, N, E, rng)
    _, jdx, jdw = _jax_vjp(jgg.grouped_matmul, x, w, sizes, dout)
    dx = tgg.grouped_matmul_dx(T(dout), T(w), T(sizes))
    dw = tgg.grouped_matmul_dw(T(x), T(dout), T(sizes))
    assert dx.dtype == dw.dtype == torch.float32
    _close(dx.numpy(), jdx, 1e-5, "dx")
    _close(dw.numpy(), jdw, 1e-5, "dw")
    if pattern == "past_sum":
        assert not dx[-7:].any()
    for g in np.flatnonzero(sizes == 0):
        assert not dw[g].any()
    # autograd through grouped_matmul reaches the same two functions
    xt, wt = T(x).requires_grad_(True), T(w).requires_grad_(True)
    gx, gw = torch.autograd.grad(tgg.grouped_matmul(xt, wt, T(sizes)), (xt, wt), T(dout))
    assert torch.equal(gx, dx) and torch.equal(gw, dw)


@pytest.mark.parametrize("sizes", [[0, 100, 120, 36], [128, 0, 0, 128]],
                         ids=["empty-first", "empty-middle"])
def test_plain_backward_equals_the_megablox_vjp_in_interpret_mode(sizes):
    from jax.experimental.pallas.ops.tpu.megablox import gmm

    rng = np.random.default_rng(6)
    N, K, F = 256, 128, 128
    x = rng.standard_normal((N, K)).astype(np.float32)
    w = rng.standard_normal((4, K, F)).astype(np.float32)
    dout = rng.standard_normal((N, F)).astype(np.float32)
    sizes = np.asarray(sizes, np.int32)
    out, jdx, jdw = _jax_vjp(lambda a, b, s: gmm(a, b, s, jnp.float32, interpret=True),
                             x, w, sizes, dout)
    _close(tgg.grouped_matmul_reference(T(x), T(w), T(sizes)).numpy(), out, 1e-5, "out")
    _close(tgg.grouped_matmul_dx(T(dout), T(w), T(sizes)).numpy(), jdx, 1e-5, "dx")
    _close(tgg.grouped_matmul_dw(T(x), T(dout), T(sizes)).numpy(), jdw, 1e-5, "dw")


def test_bf16_backward_rounds_once_from_f32_sums():
    rng = np.random.default_rng(7)
    x = T(rng.standard_normal((30, 16)).astype(np.float32)).bfloat16()
    w = T(rng.standard_normal((3, 16, 24)).astype(np.float32)).bfloat16()
    dout = T(rng.standard_normal((30, 24)).astype(np.float32)).bfloat16()
    sizes = T(np.asarray([10, 0, 20], np.int32))
    dx = tgg.grouped_matmul_dx(dout, w, sizes)
    dw = tgg.grouped_matmul_dw(x, dout, sizes)
    assert dx.dtype == dw.dtype == torch.bfloat16
    assert torch.equal(dx[:10], (dout[:10].float() @ w[0].float().T).bfloat16())
    assert torch.equal(dw[2], (x[10:].float().T @ dout[10:].float()).bfloat16())
    assert not dw[1].any()


# ---------------------------------------------------------------------------
# moe_layer
# ---------------------------------------------------------------------------


def _experts(rng, E=4, M=32, Fd=48, bias=True):
    p = {"w_gate": rng.standard_normal((E, M, Fd)) / np.sqrt(M),
         "w_up": rng.standard_normal((E, M, Fd)) / np.sqrt(M),
         "w_down": rng.standard_normal((E, Fd, M)) / np.sqrt(Fd)}
    if bias:
        p.update(b_gate=rng.standard_normal((E, Fd)) * 0.1, b_up=rng.standard_normal((E, Fd)) * 0.1,
                 b_down=rng.standard_normal((E, M)) * 0.1)
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("impl", IMPLS)
def test_moe_layer_gradients_equal_jax(impl):
    """Output, aux loss and the gradients of sum(out * c) + 3 aux with
    respect to x, the router and every expert leaf (biases included)."""
    rng = np.random.default_rng(8)
    ex = _experts(rng)
    gate = (rng.standard_normal((32, 4)) * 0.5).astype(np.float32)
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    kw = dict(k=2, impl=impl, train=True, capacity_factor=0.75, scanned=True)

    def jfun(x, gate, ex):
        res = jl.moe_layer(gate, ex, x, **kw)
        return (res.output * cot).sum() + 3.0 * res.aux_loss, res

    (jval, jres), jgrads = jax.value_and_grad(jfun, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(gate), {k: jnp.asarray(v) for k, v in ex.items()})
    tx, tgate = T(x).requires_grad_(True), T(gate).requires_grad_(True)
    tex = {k: T(v).requires_grad_(True) for k, v in ex.items()}
    res = tl.moe_layer(tgate, tex, tx, **kw)
    val = (res.output * T(cot)).sum() + 3.0 * res.aux_loss
    grads = torch.autograd.grad(val, [tx, tgate, *tex.values()])
    _close(res.output.detach().numpy(), jres.output, 1e-5, "output")
    np.testing.assert_allclose(float(res.aux_loss), float(jres.aux_loss), atol=1e-6)
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-5)
    want = [jgrads[0], jgrads[1]] + [jgrads[2][k] for k in tex]
    for name, g, w in zip(["x", "gate", *tex], grads, want):
        assert np.abs(np.asarray(w)).max() > 0, name
        _close(g.numpy(), w, 1e-5, name)
    drops = float(res.metadata["drop_fraction"])
    assert drops == float(jres.metadata["drop_fraction"])
    if impl != "ragged":
        assert drops > 0, "capacity 0.75 was to force drops"


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


def _pair(impl, **kw):
    """(jax model, jax params, port model, port params requiring grad)."""
    jm = JTransformer(jtf.tiny_moe(**MOE, moe_impl=impl, **kw))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Transformer(ttf.tiny_moe(**MOE, moe_impl=impl, **kw), device="cpu")
    tp = {k: v.requires_grad_(True)
          for k, v in params_from_numpy(jax.tree.map(np.asarray, jp)).items()}
    return jm, jp, tm, tp


def _ids(B=4, T_=33, seed=0):
    return np.random.default_rng(seed).integers(0, MOE["vocab"], size=(B, T_)).astype(np.int32)


@pytest.mark.parametrize("shared", [0, 48], ids=["routed", "shared-expert"])
@pytest.mark.parametrize("remat", ["none", "nothing_saveable"])
@pytest.mark.parametrize("impl", IMPLS)
def test_loss_and_every_gradient_equal_jax(impl, remat, shared):
    kw = dict(remat=remat != "none", remat_policy=remat, moe_shared_expert_ff=shared,
              capacity_factor=0.75)
    jm, jp, tm, tp = _pair(impl, **kw)
    batch = {"input_ids": _ids()}
    jloss, jgrads = jax.value_and_grad(jm.loss)(jp, {"input_ids": jnp.asarray(batch["input_ids"])})
    loss = tm.loss(tp, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    grads = torch.autograd.grad(loss, list(tp.values()), allow_unused=True)
    want = _flat(jax.tree.map(np.asarray, jgrads))
    assert set(want) == set(tp)
    for (name, _), g in zip(tp.items(), grads):
        if g is None:       # the norm biases: unused by RMSNorm, zero in JAX
            assert name.endswith("_b") and not want[name].any(), name
            continue
        _close(g.numpy(), want[name], 1e-4, name)
    moe = [n for n in tp if n.startswith("layers.moe_")]
    assert len(moe) == (8 if shared else 4)


def _jax_moments(jeng):
    found = {}

    def walk(node):
        if hasattr(node, "mu") and hasattr(node, "nu"):
            found.update(count=int(node.count), mu=node.mu, nu=node.nu)
        elif isinstance(node, (tuple, list)):
            for x in node:
                walk(x)

    walk(jax.device_get(jeng.state.opt_state))
    return found["count"], _flat(found["mu"]), _flat(found["nu"])


TRAIN = {"train_batch_size": 8, "steps_per_print": 10 ** 9, "zero_optimization": {"stage": 2},
         "optimizer": {"type": "FusedAdam", "params": {"lr": 3e-4, "weight_decay": 0.1}}}


# bf16 moments: 5 steps of Adam moments in bf16 sit 6-13% (relative
# Frobenius) and up to 18% (of the largest |value|) from the JAX engine's on
# this batch, against 1.5-2% for the dense model: the jitted JAX engine
# keeps excess f32 precision inside its fusions and the two sides route a
# few tokens differently (2 flips a layer at step 1, 15 at step 4 measured),
# and a flipped token's rows move to another expert. The moments are held
# to MOMENT_BF16 there; the master, the loss and the grad norm to the dense
# tolerances. Routing replayed from the card holds bf16 gradients to f32 in
# chip_smoke.py's phase 6b.
MOMENT_BF16 = 0.2


@pytest.mark.parametrize("impl,bf16,loss_tol,leaf_tol", [
    ("capacity", False, 1e-4, 1e-4), ("ragged", False, 1e-4, 1e-4),
    ("capacity", True, 2e-2, 5e-2), ("ragged", True, 2e-2, 5e-2),
], ids=["capacity-f32", "ragged-f32", "capacity-bf16", "ragged-bf16"])
def test_five_step_trajectory_and_final_state_equal_the_jax_engine(impl, bf16, loss_tol,
                                                                    leaf_tol):
    """bench.py's _config3 training config (FusedAdam, ZeRO 2) on tiny_moe
    with full remat; both engines start from the JAX engine's master."""
    config = dict(TRAIN, **({"bf16": {"enabled": True}} if bf16 else {}))
    kw = dict(moe_impl=impl, remat=True, remat_policy="nothing_saveable")
    jm = JTransformer(jtf.tiny_moe(**MOE, **kw))
    jeng, *_ = jsxt.initialize(model=jm, config=dict(config))
    master = jax.tree.map(np.asarray, jax.device_get(jeng.state.master))
    teng, *_ = sxt.initialize(model=Transformer(ttf.tiny_moe(**MOE, **kw), device="cpu"),
                              params=params_from_numpy(master), config=dict(config),
                              device="cpu")
    batch = {"input_ids": _ids(B=8, T_=17)}
    # the JAX engine differentiates the global batch's loss (not per-shard
    # capacities and aux losses): the one function the port computes
    start = master if not bf16 else jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), master)
    global_loss = float(jm.loss(start, {"input_ids": jnp.asarray(batch["input_ids"])}))
    jlosses = [float(jeng.train_batch(batch)) for _ in range(5)]
    np.testing.assert_allclose(jlosses[0], global_loss, rtol=1e-6 if not bf16 else 1e-3)
    tlosses = [float(teng.train_batch(batch)) for _ in range(5)]
    np.testing.assert_allclose(tlosses, jlosses, rtol=loss_tol)
    assert tlosses[-1] < tlosses[0]
    np.testing.assert_allclose(teng.get_global_grad_norm(), jeng.get_global_grad_norm(),
                               rtol=max(leaf_tol, 1e-3))
    got = train_state_to_numpy(teng)
    count, mu, nu = _jax_moments(jeng)
    assert got["count"] == count == got["step"] == 5
    for what, want in (("master", _flat(jax.device_get(jeng.state.master))), ("mu", mu),
                       ("nu", nu)):
        have = _flat(got[what])
        assert set(have) == set(want) and "layers.moe_w_up" in have
        tol = MOMENT_BF16 if bf16 and what != "master" else leaf_tol
        for name, w in want.items():
            _close(have[name], w, tol, f"{what}.{name}")


def test_forward_backward_step_and_the_state_converters_on_moe_leaves():
    kw = dict(moe_impl="capacity", remat=True, remat_policy="nothing_saveable")
    mk = lambda: sxt.initialize(model=Transformer(ttf.tiny_moe(**MOE, **kw), device="cpu"),
                                seed=3, config=dict(TRAIN, train_batch_size=4), device="cpu")[0]
    a, b = mk(), mk()
    batch = {"input_ids": _ids(B=4, T_=17)}
    loss = a.train_batch(batch)
    lb = b.forward(batch)
    np.testing.assert_allclose(float(b.backward(lb)), float(loss), rtol=1e-6)
    assert b.get_full_grad("moe_w_down").shape == (2, 4, 256, 32)
    assert b.get_full_grad("moe_gate").any()
    b.step()
    sa, sb = train_state_to_numpy(a), train_state_to_numpy(b)
    for what in ("master", "mu", "nu"):
        for name, w in _flat(sa[what]).items():
            np.testing.assert_allclose(_flat(sb[what])[name], w, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{what}.{name}")
    load_train_state(b, sa["master"], sa["mu"], sa["nu"], count=sa["count"])
    for what in ("master", "mu", "nu"):
        for name, w in _flat(sa[what]).items():
            np.testing.assert_array_equal(_flat(train_state_to_numpy(b)[what])[name], w)


# ---------------------------------------------------------------------------
# Launch counts and refusals
# ---------------------------------------------------------------------------


@pytest.fixture
def counted_grouped_gemm(monkeypatch):
    """The grouped-GEMM wrappers take their "kernel" branch with the plain
    versions standing in for the launches, so their counters move as on the
    card."""
    from shuffle_exchange_tpu_torch import ops

    monkeypatch.setattr(tgg, "resolve_grouped_gemm", lambda kind, t: "kernel")
    monkeypatch.setattr(tgg, "_launch", tgg.grouped_matmul_reference)
    monkeypatch.setattr(tgg, "_launch_dx", tgg.grouped_matmul_dx_reference)
    monkeypatch.setattr(tgg, "_launch_dw", tgg.grouped_matmul_dw_reference)
    ops.reset_launch_counts()
    yield ops
    ops.reset_launch_counts()


@pytest.mark.parametrize("impl,remat", [("capacity", "nothing_saveable"), ("ragged", "none")])
def test_a_training_step_launches_the_grouped_gemm_kernels_as_implied(counted_grouped_gemm,
                                                                      impl, remat):
    ops = counted_grouped_gemm
    kw = dict(moe_impl=impl, remat=remat != "none", remat_policy=remat)
    eng, *_ = sxt.initialize(model=Transformer(ttf.tiny_moe(**MOE, **kw), device="cpu"),
                             config=dict(TRAIN, train_batch_size=4), device="cpu")
    ops.reset_launch_counts()
    steps = 2
    for _ in range(steps):
        eng.train_batch({"input_ids": _ids(B=4, T_=17)})
    L, twice = MOE["layers"], (2 if remat != "none" else 1)
    counts = ops.launch_counts()
    assert counts["grouped_matmul"] == 3 * L * twice * steps
    assert counts["grouped_matmul_dx"] == counts["grouped_matmul_dw"] == 3 * L * steps
    assert set(ops.KERNEL_WRAPPERS) >= {"grouped_matmul_dx", "grouped_matmul_dw"}


def test_refusals_name_their_reasons():
    # interleaved dense and MoE layers stay refused (the JAX engines ignore
    # the pattern while its training forward honours it)
    with pytest.raises(NotImplementedError, match="moe_layer_pattern; ROADMAP queue A, item 9"):
        Transformer(ttf.tiny_moe(**MOE, moe_layer_pattern=(True, False)), device="cpu")
    Transformer(ttf.tiny_moe(**MOE, moe_layer_pattern=(True, True)), device="cpu")
    with pytest.raises(NotImplementedError, match="item 9"):
        tg.topk_select(torch.zeros(2, 4), 2, train=True, rng=torch.Generator(), noise_std=1.0)
    # a quantized expert stack serves, but has no gradient
    w = tqm.quantize_weight(torch.randn(2, 32, 16), 32, bits=8)
    x, sizes = torch.randn(6, 32), torch.tensor([4, 2], dtype=torch.int32)
    with torch.no_grad():
        assert tgg.grouped_matmul(x, w, sizes).shape == (6, 16)
    assert tgg.grouped_matmul(x, w, sizes).shape == (6, 16)       # x needs no grad
    with pytest.raises(TypeError, match="QuantizedMatrix"):
        tgg.grouped_matmul(x.requires_grad_(True), w, sizes)
    with pytest.raises(ValueError, match="disagree"):
        tgg.grouped_matmul_dx(torch.zeros(4, 8), torch.zeros(2, 16, 9), sizes)
    with pytest.raises(ValueError, match="disagree"):
        tgg.grouped_matmul_dw(torch.zeros(4, 8), torch.zeros(5, 16), sizes)
    # the backward launchers check their operands before any launch
    with pytest.raises(TypeError, match="bf16"):
        tgg._launch_dx(torch.zeros(4, 16), torch.zeros(2, 8, 16), sizes)
    with pytest.raises(ValueError, match="multiples of 8"):
        tgg._launch_dw(torch.zeros(4, 12).bfloat16(), torch.zeros(4, 16).bfloat16(), sizes)
