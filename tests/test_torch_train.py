"""The port's training (fish_speech_tpu_torch/train) against the JAX
package's (fish_speech_tpu/train) on the CPU, on tests/test_train.py's
tiny config in three versions: Fish 1.5 (a semantic range), Fish 1.2
(`semantic_end_id=None`: audio frames carry `<|semantic|>`) and DualAR
(depthwise fast embeddings and heads). The JAX parameters are carried
across through io/convert.py and both packages take the same
numpy-seeded batches, in float32.

Tolerances: the loss and its metrics within 1e-5 relative (the counts
exactly); each gradient leaf within 1e-4 of that leaf's largest JAX
value; the schedule within 1e-6 relative (both evaluate it in float32;
cos may round otherwise); optax's clip and AdamW on the same gradients
within 1e-6 relative of the largest parameter; after train steps at lr
1e-3, every parameter within one step's learning rate and all but 0.1%
of them within 1e-5 (`assert_adam_close`). Adam divides a gradient by
its own running magnitude, so where a gradient is near zero the few ulps
by which the two packages' sums differ (the gradients agree to ~5e-7 of
each leaf's largest) can move its parameter by up to about lr per step
in either package; everywhere else the parameters agree closely.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fish_speech_tpu import config as jcfg
from fish_speech_tpu.models.dual_ar import init_dual_ar_params
from fish_speech_tpu.train import dual_ar_loss as jax_loss
from fish_speech_tpu.train import step as jstep
from fish_speech_tpu_torch import config as tcfg
from fish_speech_tpu_torch.io.convert import dual_ar_params_from_numpy
from fish_speech_tpu_torch.train import TrainConfig, dual_ar_loss, init_train_state, make_train_step
from fish_speech_tpu_torch.train.checkpoint import load_train_state, save_train_state
from fish_speech_tpu_torch.train.step import (
    NO_DECAY_KEYS, decays, learning_rate, make_optimizer, tree_leaves, tree_like)

torch.set_num_threads(1)

KW = dict(vocab_size=96, n_layer=2, n_fast_layer=2, n_head=4, dim=32, intermediate_size=64,
          n_local_heads=2, head_dim=8, rope_base=10000.0, norm_eps=1e-6, max_seq_len=64,
          codebook_size=16, num_codebooks=4)
SEMANTIC = dict(im_end_id=9, pad_id=5, semantic_start_id=32, semantic_end_id=47)
VARIANTS = {
    "fish_1_5": (KW, SEMANTIC),
    # Fish <= 1.4: every audio frame's semantic token is <|semantic|>, the pad id
    "fish_1_2": (KW, dict(im_end_id=9, pad_id=5, semantic_start_id=5, semantic_end_id=None)),
    "dual_ar": (dict(KW, depthwise_wte=True, depthwise_output=True), SEMANTIC),
}
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of each leaf's largest value
SCHEDULE_RTOL = 1e-6
STEP_ATOL = 1e-5  # for all but STEP_OUTLIERS of the parameters after a few steps
STEP_OUTLIERS = 1e-3


def configs(variant):
    kw, tok = VARIANTS[variant]
    return (jcfg.DualARConfig(**kw), jcfg.TokenConfig(**tok),
            tcfg.DualARConfig(**kw), tcfg.TokenConfig(**tok))


def params_pair(jc, seed=0):
    jp = init_dual_ar_params(jax.random.PRNGKey(seed), jc, dtype=jnp.float32)
    return jp, dual_ar_params_from_numpy(jax.tree.map(np.asarray, jp))


def batch_pair(tok, cfg, seed=0, b=4, s=24):
    """A text prefix (ids below the semantic range, zero codebooks), then
    audio frames (a semantic token and random codebooks), right-padded;
    as numpy-made JAX arrays and torch tensors."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros((b, cfg.num_codebooks + 1, s), np.int32)
    seq_lens = rng.integers(s - 6, s + 1, size=(b,)).astype(np.int32)
    for i in range(b):
        text_len = int(rng.integers(3, 7))
        n_audio = seq_lens[i] - text_len
        tokens[i, 0, :text_len] = rng.integers(10, 30, size=text_len)
        if tok.semantic_end_id is None:
            tokens[i, 0, text_len:seq_lens[i]] = tok.semantic_start_id
        else:
            tokens[i, 0, text_len:seq_lens[i]] = rng.integers(
                tok.semantic_start_id, tok.semantic_end_id + 1, size=n_audio)
        tokens[i, 1:, text_len:seq_lens[i]] = rng.integers(
            0, cfg.codebook_size, size=(cfg.num_codebooks, n_audio))
        tokens[i, 0, seq_lens[i]:] = tok.pad_id
    return ({"tokens": jnp.asarray(tokens), "seq_lens": jnp.asarray(seq_lens)},
            {"tokens": torch.from_numpy(tokens), "seq_lens": torch.from_numpy(seq_lens)})


def grads(params, cfg, tok, batch, remat=True):
    live = [t.detach().requires_grad_(True) for _, t in tree_leaves(params)]
    loss, metrics = dual_ar_loss(tree_like(params, live), cfg, tok, batch, remat=remat)
    return loss, metrics, torch.autograd.grad(loss, live)


def jax_leaves(tree):
    """A JAX tree's leaves by the port's paths."""
    return dict(tree_leaves(dual_ar_params_from_numpy(jax.tree.map(np.asarray, tree))))


def assert_adam_close(got: dict, ref: dict, lr: float) -> None:
    """{name: array} trees after AdamW steps at `lr`: every value within
    lr, and all but STEP_OUTLIERS of the values within STEP_ATOL."""
    assert got.keys() == ref.keys()
    total = outliers = 0
    for k in ref:
        diff = np.abs(np.asarray(got[k], np.float64) - np.asarray(ref[k], np.float64))
        assert diff.max() <= lr, f"{k}: {diff.max()} > lr {lr}"
        total += diff.size
        outliers += int(np.sum(diff > STEP_ATOL))
    assert outliers <= STEP_OUTLIERS * total, f"{outliers} of {total} values beyond {STEP_ATOL}"


def copy_tree(tree):
    return tree_like(tree, [t.clone() for _, t in tree_leaves(tree)])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_metrics_match_jax(variant):
    jc, jt, c, t = configs(variant)
    jp, tp = params_pair(jc)
    jb, tb = batch_pair(jt, jc, seed=1)
    jl, jm = jax_loss(jp, jc, jt, jb, remat=False)
    loss, metrics = dual_ar_loss(tp, c, t, tb)
    assert set(metrics) == set(jm)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    for k in ("slow_tokens", "fast_tokens"):
        assert int(metrics[k]) == int(jm[k]), k
    for k in ("loss", "slow_loss", "fast_loss", "slow_acc", "fast_acc"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), rtol=LOSS_RTOL, err_msg=k)
    # the text prefixes keep the fast loss to audio positions only
    assert int(metrics["fast_tokens"]) < int(metrics["slow_tokens"]) * c.num_codebooks


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_gradients_match_jax(variant):
    jc, jt, c, t = configs(variant)
    jp, tp = params_pair(jc, seed=2)
    jb, tb = batch_pair(jt, jc, seed=3)
    jg = jax.grad(lambda p: jax_loss(p, jc, jt, jb, remat=False)[0])(jp)
    _, _, g = grads(tp, c, t, tb)
    ref = jax_leaves(jg)
    assert list(ref) == [path for path, _ in tree_leaves(tp)]
    for (path, want), got in zip(ref.items(), g):
        scale = float(want.abs().max())
        assert scale > 0, path
        err = float((got - want).abs().max())
        assert err <= GRAD_TOL * scale, f"{path}: {err} > {GRAD_TOL} x {scale}"


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_remat_is_bit_equal(variant):
    """The slow layers run again in the backward with remat: the same
    operations on the same inputs, so the gradients are bit-equal."""
    _, jt, c, t = configs(variant)
    _, tp = params_pair(configs(variant)[0], seed=4)
    _, tb = batch_pair(jt, c, seed=5)
    l1, _, g1 = grads(tp, c, t, tb, remat=True)
    l2, _, g2 = grads(tp, c, t, tb, remat=False)
    assert torch.equal(l1, l2)
    for (path, _), a, b in zip(tree_leaves(tp), g1, g2):
        assert torch.equal(a, b), path


def test_remat_only_while_grad_is_enabled(monkeypatch):
    """Without grad (the quality proxies' forwards) no layer is
    checkpointed; with grad each slow layer is."""
    from fish_speech_tpu_torch.train import loss as tloss

    calls = []
    monkeypatch.setattr(tloss, "checkpoint", lambda fn, *a, **k: calls.append(1) or fn(*a))
    _, jt, c, t = configs("fish_1_5")
    _, tp = params_pair(configs("fish_1_5")[0])
    _, tb = batch_pair(jt, c)
    with torch.no_grad():
        tloss.slow_forward_full(tp, c, t, tb["tokens"], tb["seq_lens"], remat=True)
    assert calls == []
    tloss.slow_forward_full(tp, c, t, tb["tokens"], tb["seq_lens"], remat=True)
    assert len(calls) == c.n_layer


@pytest.mark.parametrize("warmup,total", [(5, 12), (0, 6), (3, 3), (1, 8)])
def test_schedule_matches_optax(warmup, total):
    tc = TrainConfig(learning_rate=3e-4, warmup_steps=warmup, total_steps=total,
                     min_lr_ratio=0.1)
    ref = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=tc.learning_rate, warmup_steps=warmup,
        decay_steps=max(total, warmup + 1), end_value=tc.learning_rate * tc.min_lr_ratio)
    for count in range(warmup + 3):
        got = learning_rate(tc, torch.tensor(count, dtype=torch.int32))
        assert got.dtype == torch.float32
        want = float(ref(jnp.asarray(count, jnp.int32)))
        np.testing.assert_allclose(float(got), want, rtol=SCHEDULE_RTOL, atol=0,
                                   err_msg=f"count {count}")
    first = float(learning_rate(tc, torch.tensor(0, dtype=torch.int32)))
    assert first == (0.0 if warmup else float(np.float32(tc.learning_rate)))


def _tiny_tree(rng):
    return {"embeddings": rng.normal(size=(6, 4)), "norm": 1 + 0.1 * rng.normal(size=(4,)),
            "slow": {"wqkv": rng.normal(size=(2, 4, 5)), "ffn_norm": rng.normal(size=(2, 4))}}


@pytest.mark.parametrize("norm", [0.5, 3.0], ids=["below_clip", "above_clip"])
def test_clip_and_adamw_match_optax(norm):
    """The port's optimizer and the JAX package's optax chain on the same
    parameters and gradients, two updates: the gradients' global norm
    below and above grad_clip (optax keeps them, or scales them by
    grad_clip / norm)."""
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), _tiny_tree(rng))
    gsteps = []
    for _ in range(2):
        g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), tree)
        total = np.sqrt(sum(float(np.sum(x * x)) for x in jax.tree.leaves(g)))
        gsteps.append(jax.tree.map(lambda x: (x * (norm / total)).astype(np.float32), g))
    tc = TrainConfig(learning_rate=1e-2, warmup_steps=1, total_steps=10, grad_clip=1.0,
                     weight_decay=0.1)
    jtc = jstep.TrainConfig(learning_rate=1e-2, warmup_steps=1, total_steps=10, grad_clip=1.0,
                            weight_decay=0.1)
    opt = jstep.make_optimizer(jtc)
    jp = jax.tree.map(jnp.asarray, tree)
    js = opt.init(jp)
    tp = dual_ar_params_from_numpy(tree)
    topt = make_optimizer(tc)
    ts = topt.init(tp)
    for g in gsteps:
        upd, js = opt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        norm_got = topt.update([t for _, t in tree_leaves(dual_ar_params_from_numpy(g))], ts, tp)
        np.testing.assert_allclose(float(norm_got), float(optax.global_norm(g)), rtol=1e-6)
    assert int(ts["count"]) == 2
    scale = max(float(np.abs(a).max()) for a in jax.tree.leaves(tree))
    for path, want in jax_leaves(jp).items():
        got = dict(tree_leaves(tp))[path]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6 * scale,
                                   err_msg=str(path))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_three_steps_match_jax(variant):
    jc, jt, c, t = configs(variant)
    jp, tp = params_pair(jc, seed=11)
    batches = [batch_pair(jt, jc, seed=20 + i) for i in range(3)]
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=8, remat=False)
    jtc, tc = jstep.TrainConfig(**kw), TrainConfig(**kw)
    jp, js = jstep.init_train_state(jp, jtc)
    jfn = jstep.make_train_step(jc, jt, jtc, donate=False)
    tp, ts = init_train_state(tp, tc)
    tfn = make_train_step(c, t, tc)
    for jb, tb in batches:
        jp, js, jm = jfn(jp, js, jb)
        tp, ts, tm = tfn(tp, ts, tb)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_RTOL, err_msg=k)
    assert int(ts["count"]) == 3
    assert_adam_close({p: t.numpy() for p, t in tree_leaves(tp)},
                      {p: t.numpy() for p, t in jax_leaves(jp).items()}, kw["learning_rate"])


def test_decayed_leaves_by_name():
    """Which leaves AdamW decays: everything but the norm scales, the
    embeddings and heads included, as the JAX optimizer's mask does
    (its comment says embeddings are not decayed; its code decays them).
    Shown on both optimizers by one step on zero gradients from count 0
    without warmup, where a leaf moves only by its decay."""
    jc, _, c, _ = configs("fish_1_5")
    jp, tp = params_pair(jc)
    kw = dict(learning_rate=1e-2, warmup_steps=0, total_steps=4, weight_decay=0.5)
    opt = jstep.make_optimizer(jstep.TrainConfig(**kw))
    upd, _ = opt.update(jax.tree.map(jnp.zeros_like, jp), opt.init(jp), jp)
    jax_moved = {path for path, u in jax_leaves(upd).items() if bool(u.abs().max() > 0)}
    before = copy_tree(tp)
    topt = make_optimizer(TrainConfig(**kw))
    topt.update([torch.zeros_like(x) for _, x in tree_leaves(tp)], topt.init(tp), tp)
    port_moved = {path for (path, a), (_, b) in zip(tree_leaves(before), tree_leaves(tp))
                  if not torch.equal(a, b)}
    named = {path for path, _ in tree_leaves(tp) if decays(path)}
    assert jax_moved == port_moved == named
    assert named == {("codebook_embeddings",), ("embeddings",), ("fast_embeddings",),
                     ("output",), ("fast_output",)} | {
        (stack, k) for stack in ("slow", "fast") for k in ("wqkv", "wo", "w1", "w3", "w2")}
    assert not any(k in NO_DECAY_KEYS for path in named for k in path)


def test_loss_decreases():
    jc, jt, c, t = configs("fish_1_5")
    _, tp = params_pair(jc)
    tc = TrainConfig(learning_rate=3e-3, warmup_steps=2, total_steps=60, grad_clip=1.0,
                     remat=True)
    tp, ts = init_train_state(tp, tc)
    step = make_train_step(c, t, tc)
    _, batch = batch_pair(jt, jc, seed=2)
    first = None
    for _ in range(40):
        tp, ts, metrics = step(tp, ts, batch)
        if first is None:
            first = float(metrics["loss"])
    last = float(metrics["loss"])
    assert np.isfinite(first) and np.isfinite(last)
    assert last < 0.5 * first, (first, last)
    assert int(metrics["fast_tokens"]) < int(metrics["slow_tokens"]) * c.num_codebooks


def _state(seed, tc):
    jp = init_dual_ar_params(jax.random.PRNGKey(seed), configs("fish_1_5")[0], dtype=jnp.float32)
    return init_train_state(dual_ar_params_from_numpy(jax.tree.map(np.asarray, jp)), tc)


def test_train_state_round_trip(tmp_path):
    """save -> load into other templates: every tensor, the step, extra
    and the RNG's stream come back exactly; bfloat16 leaves too."""
    _, jt, c, t = configs("fish_1_5")
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=4)
    p, s = _state(1, tc)
    p["norm"] = p["norm"].to(torch.bfloat16)  # a bf16 leaf and its bf16 second moment
    s["nu"]["norm"] = s["nu"]["norm"].to(torch.bfloat16) + 0.125
    rng = np.random.default_rng(42)
    rng.integers(0, 1000, size=5)
    save_train_state(tmp_path / "st.npz", step=7, params=p, opt_state=s, rng=rng,
                     extra={"order": [3, 1, 2]})
    p2, s2 = _state(2, tc)
    p2["norm"] = p2["norm"].to(torch.bfloat16)
    s2["nu"]["norm"] = s2["nu"]["norm"].to(torch.bfloat16)
    step, p3, s3, rng3, extra = load_train_state(tmp_path / "st.npz", p2, s2)
    assert step == 7 and extra == {"order": [3, 1, 2]}
    np.testing.assert_array_equal(rng.integers(0, 1000, size=8), rng3.integers(0, 1000, size=8))
    for (path, a), (_, b) in zip(tree_leaves(p) + tree_leaves(s), tree_leaves(p3) + tree_leaves(s3)):
        assert a.dtype == b.dtype and torch.equal(a, b), path


def test_checkpoint_resume_bit_exact(tmp_path):
    """A snapshot after 3 of 6 steps, loaded into a fresh state of other
    weights, continues to the uninterrupted run's parameters and moments
    bit for bit (the schedule's count rides in the optimizer state)."""
    jc, jt, c, t = configs("fish_1_5")
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=8, remat=False)
    batches = [batch_pair(jt, jc, seed=100 + i)[1] for i in range(6)]
    step = make_train_step(c, t, tc)
    pa, sa = _state(7, tc)
    for b in batches:
        pa, sa, _ = step(pa, sa, b)
    pb, sb = _state(7, tc)
    for b in batches[:3]:
        pb, sb, _ = step(pb, sb, b)
    save_train_state(tmp_path / "st.npz", step=3, params=pb, opt_state=sb)
    pc, sc = _state(8, tc)
    got, pc, sc, rng, _ = load_train_state(tmp_path / "st.npz", pc, sc)
    assert got == 3 and rng is None
    for b in batches[3:]:
        pc, sc, _ = step(pc, sc, b)
    for (path, a), (_, b) in zip(tree_leaves(pa) + tree_leaves(sa), tree_leaves(pc) + tree_leaves(sc)):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("other", ["model", "dtype", "not_a_state"])
def test_checkpoint_rejects_mismatched_state(tmp_path, other):
    """A snapshot of another model shape, or of parameters in another
    dtype (so other moments), or a file that is no train state, raises
    ValueError instead of loading into the wrong leaves."""
    _, _, c, _ = configs("fish_1_5")
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=4)
    p, s = _state(1, tc)
    path = tmp_path / "st.npz"
    save_train_state(path, step=1, params=p, opt_state=s)
    if other == "model":
        small = dataclasses.replace(configs("fish_1_5")[0], dim=16, head_dim=4,
                                    intermediate_size=32)
        jp = init_dual_ar_params(jax.random.PRNGKey(0), small, dtype=jnp.float32)
        p2, s2 = init_train_state(dual_ar_params_from_numpy(jax.tree.map(np.asarray, jp)), tc)
    elif other == "dtype":
        p2, s2 = init_train_state(tree_like(p, [x.to(torch.bfloat16) for _, x in tree_leaves(p)]),
                                  tc)
    else:
        p2, s2 = p, s
        np.savez(path, __meta__=np.frombuffer(b'{"magic": "other"}', dtype=np.uint8))
    with pytest.raises(ValueError):
        load_train_state(path, p2, s2)
