"""The port's training engine against the JAX engine, on the CPU.

Both engines start from one state (the JAX engine's initial f32 master,
moved over as numpy arrays), take the same numpy-seeded batch for N = 5
steps, and must agree on the loss trajectory, the final master and both
Adam moments: within 1e-4 in f32 (relative to each leaf's largest |value|;
the same arithmetic in another summation order) and, in bf16, within 2e-2
of the loss and 5e-2 of each leaf's largest |value| (the two frameworks
round bf16 at different points of the layer body). The JAX engine runs on
the 8-device virtual mesh of ``tests/conftest.py``, the port at world size
1: the global batch and the mathematics are the same. The config dicts are
the one-chip benchmark rows' ``cfg1`` (AdamW, ZeRO 1) and ``cfg2``
(FusedAdam, ZeRO 3) at tiny scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shuffle_exchange_tpu as jsxt
import shuffle_exchange_tpu_torch as sxt
from shuffle_exchange_tpu.models import Transformer as JTransformer
from shuffle_exchange_tpu.models import tiny as jtiny
from shuffle_exchange_tpu_torch.config import ConfigError
from shuffle_exchange_tpu_torch.models import (Transformer, load_train_state, params_from_numpy,
                                               tiny, train_state_to_numpy)
from shuffle_exchange_tpu_torch.runtime import loss_scaler as tls
from shuffle_exchange_tpu_torch.runtime import lr_schedules as tlr

LLAMA = dict(vocab=97, d=32, layers=2, heads=4, seq=32, activation="swiglu", norm="rmsnorm",
             position="rope", n_kv_heads=2, remat=True, remat_policy="nothing_saveable")
CFG1 = {"train_batch_size": 8, "steps_per_print": 10 ** 9, "zero_optimization": {"stage": 1},
        "optimizer": {"type": "AdamW", "params": {"lr": 3e-4, "weight_decay": 0.1}}}
CFG2 = {"train_batch_size": 8, "steps_per_print": 10 ** 9, "zero_optimization": {"stage": 3},
        "optimizer": {"type": "FusedAdam", "params": {"lr": 3e-4, "weight_decay": 0.1}}}
BF16 = {"bf16": {"enabled": True}}
N = 5


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _batch(seed=0, B=8, T=17):
    return {"input_ids": np.random.default_rng(seed).integers(0, 97, size=(B, T)).astype(np.int32)}


def _engines(config):
    """(jax engine, port engine) started from the JAX engine's master."""
    jeng, *_ = jsxt.initialize(model=JTransformer(jtiny(**LLAMA)), config=dict(config))
    master = jax.tree.map(np.asarray, jax.device_get(jeng.state.master))
    teng, opt, loader, sched = sxt.initialize(model=Transformer(tiny(**LLAMA), device="cpu"),
                                              params=params_from_numpy(master),
                                              config=dict(config), device="cpu")
    assert loader is None and opt is teng.tx and sched is teng.lr_schedule
    return jeng, teng


def _jax_moments(jeng):
    """(count, mu, nu) out of the optax state, whatever its nesting."""
    found = {}

    def walk(node):
        if hasattr(node, "mu") and hasattr(node, "nu"):
            found.update(count=int(node.count), mu=node.mu, nu=node.nu)
        elif isinstance(node, (tuple, list)):
            for x in node:
                walk(x)

    walk(jax.device_get(jeng.state.opt_state))
    return found["count"], _flat(found["mu"]), _flat(found["nu"])


def _assert_state(jeng, teng, tol):
    got = train_state_to_numpy(teng)
    count, mu, nu = _jax_moments(jeng)
    assert got["count"] == count == got["step"] == int(jeng.state.step)
    for what, want in (("master", _flat(jax.device_get(jeng.state.master))), ("mu", mu),
                       ("nu", nu)):
        have = _flat(got[what])
        assert set(have) == set(want)
        for name, w in want.items():
            scale = max(float(np.abs(w).max()), 1e-12)
            np.testing.assert_allclose(have[name] / scale, w / scale, atol=tol,
                                       err_msg=f"{what}.{name}")


@pytest.mark.parametrize("config,loss_tol,leaf_tol", [
    (CFG1, 1e-4, 1e-4),
    (dict(CFG2, train_batch_size=32, gradient_accumulation_steps=4, gradient_clipping=0.5),
     1e-4, 1e-4),
    (dict(CFG2, **BF16), 2e-2, 5e-2),
], ids=["cfg1-f32", "cfg2-f32-gas4-clip", "cfg2-bf16"])
def test_five_step_trajectory_and_final_state_equal_the_jax_engine(config, loss_tol, leaf_tol):
    jeng, teng = _engines(config)
    B = config["train_batch_size"]       # 32 rows for gas 4: one row a device and micro-batch
    batch = _batch(B=B)
    jlosses = [float(jeng.train_batch(batch)) for _ in range(N)]
    tlosses = [float(teng.train_batch(batch)) for _ in range(N)]
    np.testing.assert_allclose(tlosses, jlosses, rtol=loss_tol)
    assert tlosses[-1] < tlosses[0]
    assert teng.global_steps == jeng.global_steps == N
    assert teng.global_samples == jeng.global_samples == B * N
    np.testing.assert_allclose(teng.get_global_grad_norm(), jeng.get_global_grad_norm(),
                               rtol=max(loss_tol, 1e-3))
    assert teng.get_lr() == pytest.approx(jeng.get_lr())
    assert teng.zero_optimization_stage() == config["zero_optimization"]["stage"]
    _assert_state(jeng, teng, leaf_tol)
    if "bf16" in config:
        weights = teng.module_weights()
        assert all(w.dtype == torch.bfloat16 for w in weights.values())
        np.testing.assert_allclose(float(teng.eval_batch(batch)), float(jeng.eval_batch(batch)),
                                   rtol=loss_tol)


WARMUP = {"scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 0.0,
                                                        "warmup_max_lr": 3e-3,
                                                        "warmup_num_steps": 4,
                                                        "warmup_type": "linear"}}}


@pytest.mark.parametrize("base", [CFG2, CFG1], ids=["cfg2-kernel-path", "cfg1-optax"])
def test_five_step_trajectory_under_warmup_equals_the_jax_engine(base):
    """With a scheduler the two AdamW routes of the JAX package differ by
    one schedule step, and the port follows each: FusedAdam reads the
    schedule where ``pallas_adamw`` reads it (the JAX engine steps that
    transformation here as on a TPU; its body on the CPU is the kernel's
    plain version), AdamW where ``optax.adamw`` reads it. Under linear
    warm-up from 0 the first optax update has lr 0 and leaves the master as
    it was."""
    from shuffle_exchange_tpu.ops.fused_adam import pallas_adamw
    from shuffle_exchange_tpu.runtime.lr_schedules import build_schedule as jbuild
    from shuffle_exchange_tpu.config.config import SchedulerConfig as JSchedulerConfig

    config = dict(base, **WARMUP)
    client = None
    if base is CFG2:
        sched = jbuild(JSchedulerConfig(type="WarmupLR", params=dict(WARMUP["scheduler"]["params"])),
                       3e-4)
        client = pallas_adamw(sched, weight_decay=0.1)
    jeng, *_ = jsxt.initialize(model=JTransformer(jtiny(**LLAMA)), config=dict(config),
                               optimizer=client)
    master = jax.tree.map(np.asarray, jax.device_get(jeng.state.master))
    teng, *_ = sxt.initialize(model=Transformer(tiny(**LLAMA), device="cpu"),
                              params=params_from_numpy(master), config=dict(config),
                              device="cpu")
    assert teng.tx.schedule_offset == (1 if base is CFG2 else 0)
    batch = _batch()
    jlosses = [float(jeng.train_batch(batch)) for _ in range(N)]
    tlosses = [float(teng.train_batch(batch)) for _ in range(N)]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    moved = tlosses[1] != tlosses[0]
    assert moved == (base is CFG2)            # optax's first update has lr 0
    assert teng.get_lr() == pytest.approx(jeng.get_lr())
    _assert_state(jeng, teng, 1e-4)


def test_forward_backward_step_equals_train_batch():
    """Two micro-batches through forward / backward / step leave the state
    of one train_batch with gas 2 on the same 8 rows, and the accessors
    read and write the state by name."""
    batch = _batch(B=8)
    halves = [{"input_ids": batch["input_ids"][i:i + 4]} for i in (0, 4)]
    fused, *_ = sxt.initialize(model=Transformer(tiny(**LLAMA), device="cpu"), seed=3,
                               config=dict(CFG2, gradient_accumulation_steps=2), device="cpu")
    staged, *_ = sxt.initialize(model=Transformer(tiny(**LLAMA), device="cpu"), seed=3,
                                config=dict(CFG2, train_batch_size=4), device="cpu")
    assert staged.get_full_grad("wq") is None
    loss = fused.train_batch(batch)
    parts = []
    for half in halves:
        l0 = staged.forward(half)
        parts.append(float(staged.backward(l0)))
    assert staged.get_full_grad("wq").shape == (2, 32, 32)
    staged.step()
    assert staged.micro_steps == 2 and staged.global_steps == 1 and staged.state.step == 1
    np.testing.assert_allclose(float(loss), np.mean(parts), rtol=1e-6)
    a, b = train_state_to_numpy(fused), train_state_to_numpy(staged)
    for what in ("master", "mu", "nu"):
        for name, w in _flat(a[what]).items():
            np.testing.assert_allclose(_flat(b[what])[name], w, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{what}.{name}")
    with pytest.raises(ConfigError, match="backward"):
        staged.step()
    # accessors: by full or short name, optimizer moments by either spelling
    w = staged.get_full_fp32_param("layers.wq")
    staged.set_full_fp32_param("wq", w * 2)
    np.testing.assert_array_equal(staged.get_full_fp32_param("wq"), w * 2)
    np.testing.assert_array_equal(staged.get_full_optimizer_state("wq", "exp_avg"),
                                  staged.get_full_optimizer_state("layers.wq", "mu"))
    staged.set_full_optimizer_state("wq", "exp_avg_sq", np.ones_like(w))
    assert (staged.get_full_optimizer_state("wq", "nu") == 1).all()
    with pytest.raises(KeyError):
        staged.get_full_fp32_param("nope")
    # the converters put a state back bit for bit
    snap = train_state_to_numpy(fused)
    load_train_state(staged, snap["master"], snap["mu"], snap["nu"], count=snap["count"])
    again = train_state_to_numpy(staged)
    for what in ("master", "mu", "nu"):
        for name, w in _flat(snap[what]).items():
            np.testing.assert_array_equal(_flat(again[what])[name], w)
    assert again["count"] == snap["count"] == again["step"]


def _toy(din=8, dh=32, dout=4):
    rng = np.random.default_rng(0)
    params = {"w1": rng.normal(size=(din, dh)).astype(np.float32) * 0.1,
              "b1": np.zeros(dh, np.float32),
              "w2": rng.normal(size=(dh, dout)).astype(np.float32) * 0.1,
              "b2": np.zeros(dout, np.float32)}

    def tloss(p, batch, rng=None):
        x, y = batch["x"].to(p["w1"].dtype), batch["y"].long()
        h = torch.tanh(x @ p["w1"] + p["b1"])
        return torch.nn.functional.cross_entropy((h @ p["w2"] + p["b2"]).float(), y)

    def jloss(p, batch, rng=None):
        x, y = batch["x"], batch["y"]
        h = jnp.tanh(x @ p["w1"].astype(x.dtype) + p["b1"].astype(x.dtype))
        logits = h @ p["w2"].astype(x.dtype) + p["b2"].astype(x.dtype)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1))

    return params, tloss, jloss


def _toy_batch(n=32, nan=False):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    return {"x": np.full_like(x, np.nan) if nan else x,
            "y": rng.integers(0, 4, size=(n,)).astype(np.int32)}


def _bits(eng):
    st = eng.state
    return [t.clone() for d in (st.master, st.opt_state.mu, st.opt_state.nu) for t in d.values()]


def test_fp16_overflow_skip_follows_the_jax_engine():
    """The dynamic loss scale under overflow (the JAX package's
    ``test_fp16_dynamic_loss_scale_overflow_skip``): the first overflow
    consumes hysteresis, the second halves the scale; skipped steps leave
    master, moments and the update count bit-equal."""
    params, tloss, jloss = _toy()
    cfg = {"train_batch_size": 32, "steps_per_print": 1000,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}},
           "fp16": {"enabled": True, "initial_scale_power": 4}}
    teng, *_ = sxt.initialize(model={k: torch.from_numpy(v) for k, v in params.items()},
                              loss_fn=tloss, config=dict(cfg), device="cpu")
    jeng, *_ = jsxt.initialize(params={k: jnp.asarray(v) for k, v in params.items()},
                               loss_fn=jloss, config=dict(cfg))
    good, bad = _toy_batch(), _toy_batch(nan=True)
    teng.train_batch(good)
    jeng.train_batch(good)
    before = _bits(teng)
    scales = []
    for _ in range(2):
        teng.train_batch(bad)
        jeng.train_batch(bad)
        scales.append((teng.loss_scale(), jeng.loss_scale()))
    assert scales == [(16.0, 16.0), (8.0, 8.0)]
    assert all(torch.equal(a, b) for a, b in zip(before, _bits(teng)))
    assert teng.state.step == int(jeng.state.step) == 1 and teng.state.opt_state.count == 1
    assert teng.skipped_steps == jeng.skipped_steps == 2 and teng.global_steps == 3
    tl = [float(teng.train_batch(good)) for _ in range(3)]
    jl = [float(jeng.train_batch(good)) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=2e-2)      # fp16 rounding differs by framework
    assert np.isfinite(tl).all()


@pytest.mark.parametrize("policy", ["skip", "off"])
def test_nan_batch_leaves_the_state_bit_equal_under_skip(policy):
    params, tloss, _ = _toy()
    cfg = {"train_batch_size": 32, "resilience": {"nonfinite_policy": policy},
           "optimizer": {"type": "FusedAdam", "params": {"lr": 1e-2, "weight_decay": 0.1}}}
    eng, *_ = sxt.initialize(model={k: torch.from_numpy(v) for k, v in params.items()},
                             loss_fn=tloss, config=cfg, device="cpu")
    eng.train_batch(_toy_batch())
    before = _bits(eng)
    loss = eng.train_batch(_toy_batch(nan=True))
    assert torch.isnan(loss)
    same = all(torch.equal(a, b) for a, b in zip(before, _bits(eng)))
    if policy == "skip":
        assert same and eng.state.step == 1 and eng.global_steps == 2 and eng.skipped_steps == 0
    else:       # "off": the reference behaviour, the bad update is applied
        assert not same and eng.state.step == 2


@pytest.mark.parametrize("name,params", [
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-3, "lr_range_test_step_size": 5,
                     "lr_range_test_step_rate": 2.0}),
    ("LRRangeTest", {"lr_range_test_step_size": 4, "lr_range_test_staircase": True}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-2, "cycle_first_step_size": 6,
                  "cycle_second_step_size": 4, "decay_lr_rate": 0.5, "decay_step_size": 2}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-2, "cycle_first_step_size": 5}),
    ("WarmupLR", {"warmup_max_lr": 1e-2, "warmup_num_steps": 7}),
    ("WarmupLR", {"warmup_min_lr": 1e-4, "warmup_max_lr": 1e-2, "warmup_num_steps": 7,
                  "warmup_type": "linear"}),
    ("WarmupDecayLR", {"total_num_steps": 20, "warmup_max_lr": 1e-2, "warmup_num_steps": 5}),
    ("WarmupCosineLR", {"total_num_steps": 20, "warmup_num_steps": 5, "warmup_min_ratio": 0.1}),
    ("Constant", {"lr": 3e-3}), (None, {}),
], ids=lambda v: v if isinstance(v, str) else None)
def test_lr_schedules_equal_jax_point_by_point(name, params):
    from shuffle_exchange_tpu.config import SchedulerConfig as JSched
    from shuffle_exchange_tpu.runtime.lr_schedules import build_schedule as jbuild
    from shuffle_exchange_tpu_torch.config import SchedulerConfig

    want = jbuild(JSched(type=name, params=dict(params)), 2e-3)
    got = tlr.build_schedule(SchedulerConfig(type=name, params=dict(params)), 2e-3)
    # JAX evaluates in f32 (max - (max - min) cancels to ~2e-6 relative at
    # the end of a cycle), the port in Python floats
    for step in range(0, 30):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-5, err_msg=str(step))
    with pytest.raises(ConfigError, match="Unknown scheduler"):
        tlr.build_schedule(SchedulerConfig(type="Nope"), 1e-3)


@pytest.mark.parametrize("fp16", [
    {"enabled": True, "initial_scale_power": 4, "loss_scale_window": 3, "hysteresis": 2},
    {"enabled": True, "initial_scale_power": 3, "loss_scale_window": 2, "hysteresis": 1,
     "min_loss_scale": 2.0},
    {"enabled": True, "initial_scale_power": 4, "loss_scale_window": 4, "hysteresis": 3,
     "consecutive_hysteresis": True},
    {"enabled": True, "loss_scale": 128.0}, {"enabled": False},
], ids=["window3-hyst2", "min-scale", "consecutive", "static", "off"])
def test_loss_scaler_equals_jax_point_by_point(fp16):
    from shuffle_exchange_tpu.config import FP16Config as JFP16
    from shuffle_exchange_tpu.runtime import loss_scaler as jls
    from shuffle_exchange_tpu_torch.config import FP16Config

    jcfg, tcfg = JFP16.from_dict(fp16), FP16Config.from_dict(fp16)
    js, ts = jls.init_loss_scale(jcfg), tls.init_loss_scale(tcfg)
    flags = np.random.default_rng(0).random(40) < 0.35
    for over in flags:
        js = jls.update(js, jnp.asarray(bool(over)), jcfg)
        ts = tls.update(ts, bool(over), tcfg)
        assert (ts.scale, ts.good_steps, ts.hysteresis_left) == (
            float(js.scale), int(js.good_steps), int(js.hysteresis_left))
    grads = {"a": torch.ones(3), "b": torch.tensor([1.0, float("inf")])}
    assert bool(tls.check_overflow(grads)) and not bool(tls.check_overflow({"a": grads["a"]}))
