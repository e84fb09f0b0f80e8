"""The port's training substrate: the twins of ``tests/test_train.py``
(learning, determinism, microbatching, checkpointing, restart) on the
CPU, and its optimizer, train step and checkpoints held against the JAX
reference (same numpy weights and batch; tolerances beside each check).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.checkpoint import Checkpointer as JCheckpointer
from repro.train import AdamWConfig as JAdamW
from repro.train import init_train_state as j_init_state
from repro.train import make_train_step as j_make_step
from repro.train import optimizer as j_opt

import repro_torch.configs as C
from repro_torch import convert, pytree
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import DataConfig, batch_for_step
from repro_torch.launch import train as train_cli
from repro_torch.models import init_params
from repro_torch.train import (AdamWConfig, init_train_state,
                               make_train_step, optimizer)

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The reduced models' ops are tiny: one intra-op thread runs them as
    fast, and keeps parallel test workers from oversubscribing the
    host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_setup():
    cfg = C.get("phi3-mini-3.8b").reduced()
    dc = DataConfig(task="copy", vocab=cfg.vocab, seq_len=32,
                    global_batch=16)
    params = init_params(cfg, 0, device=CPU)
    return cfg, dc, params


def _step(dc, i):
    return batch_for_step(dc, i, device=CPU)


def _np_tree(tree):
    return dict(pytree.leaves_with_paths(convert.lm_params_to_numpy(tree)))


def _j_tree(tree):
    return jax.tree.map(jnp.asarray, convert.lm_params_to_numpy(tree))


# ------------------------------------------------ twins of test_train.py
def test_loss_decreases(small_setup):
    cfg, dc, params = small_setup
    state = init_train_state(cfg, params, device=CPU)
    step = make_train_step(cfg, AdamWConfig(lr=3e-3, warmup_steps=10,
                                            decay_steps=300))
    losses = []
    for i in range(250):
        state, m = step(state, _step(dc, i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])


def test_data_pipeline_deterministic_and_sharded():
    dc = DataConfig(task="lm", vocab=64, seq_len=16, global_batch=8)
    a = batch_for_step(dc, 7, device=CPU)
    b = batch_for_step(dc, 7, device=CPU)
    torch.testing.assert_close(a["tokens"], b["tokens"], rtol=0, atol=0)
    c = batch_for_step(dc, 8, device=CPU)
    assert not torch.equal(a["tokens"], c["tokens"])
    # shard slicing partitions the global batch
    s0 = batch_for_step(dc, 7, shard=(0, 2), device=CPU)["tokens"]
    s1 = batch_for_step(dc, 7, shard=(1, 2), device=CPU)["tokens"]
    assert torch.equal(torch.cat([s0, s1]), a["tokens"])
    assert a["tokens"].dtype == torch.int32
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 64


@pytest.mark.parametrize("seq_len", [32, 33])
def test_copy_task_structure_and_media(seq_len):
    """The copy task keeps the reference's layout: the second half
    repeats the first, tokens in [2, vocab), an odd tail padded with 1;
    media shard like the tokens."""
    dc = DataConfig(task="copy", vocab=50, seq_len=seq_len, global_batch=6,
                    seed=3, n_media_tokens=4, d_model=8)
    full = batch_for_step(dc, 5, device=CPU)
    t = full["tokens"]
    assert t.shape == (6, seq_len)
    half = seq_len // 2
    assert torch.equal(t[:, :half], t[:, half:2 * half])
    assert int(t[:, :2 * half].min()) >= 2 and int(t.max()) < 50
    assert bool((t[:, 2 * half:] == 1).all())
    assert full["media"].shape == (6, 4, 8)
    parts = [batch_for_step(dc, 5, shard=(r, 3), device=CPU)
             for r in range(3)]
    for key in ("tokens", "media"):
        assert torch.equal(torch.cat([p[key] for p in parts]), full[key])
    other = batch_for_step(DataConfig(task="copy", vocab=50,
                                      seq_len=seq_len, global_batch=6,
                                      seed=4), 5, device=CPU)
    assert not torch.equal(other["tokens"], t)


def test_microbatch_equivalence(small_setup):
    """grad accumulation over 2 microbatches == single batch step (same
    data, same update) within fp tolerance."""
    cfg, dc, params = small_setup
    opt = AdamWConfig(lr=1e-3)
    s1 = init_train_state(cfg, params, device=CPU)
    s2 = init_train_state(cfg, params, device=CPU)
    batch = _step(dc, 0)
    s1, _ = make_train_step(cfg, opt, n_microbatches=1)(s1, batch)
    s2, _ = make_train_step(cfg, opt, n_microbatches=2)(s2, batch)
    worst = max(float((a - b).abs().max()) for a, b in zip(
        pytree.leaves(s1["params"]), pytree.leaves(s2["params"])))
    assert worst < 5e-3, worst


def test_microbatch_step_matches_reference(small_setup):
    """Two microbatches, then two more steps with clipping and the
    schedule live, against the reference's step on the same batches.
    float32 and f32 accumulation in both; Adam moves a leaf whose grad
    is near 0 by a fraction of lr that a last-bit grad difference
    changes, so params are held within a tenth of lr, as in
    ``test_train_step_matches_reference``."""
    cfg, dc, params = small_setup
    rcfg = RC.get("phi3-mini-3.8b").reduced()
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, clip_norm=0.5)
    jopt = JAdamW(lr=1e-3, warmup_steps=2, clip_norm=0.5)
    state = init_train_state(cfg, params, opt, device=CPU)
    jstate = j_init_state(rcfg, _j_tree(params), jopt)
    step = make_train_step(cfg, opt, n_microbatches=2)
    jstep = jax.jit(j_make_step(rcfg, jopt, n_microbatches=2))
    for i in range(3):
        batch = _step(dc, i)
        state, m = step(state, batch)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(
            batch["tokens"].numpy())})
        for k in ("loss", "grad_norm", "lr"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    got = _np_tree(state)
    for name, want in pytree.leaves_with_paths(
            jax.tree.map(np.asarray, jstate)):
        np.testing.assert_allclose(got[name], want, rtol=0, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_optimizer_update_matches_reference(moments):
    """``optimizer.update`` on the same grads and state, four steps deep
    (warmup, cosine, clipping on and off), bf16 moments too."""
    rng = np.random.default_rng(7)
    shapes = {"a": {"w": (8, 16), "b": (16,)}, "c": (4, 3, 5)}
    params = pytree.tree_map(
        lambda s: torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)), shapes, )
    cfg = AdamWConfig(lr=0.1, warmup_steps=2, decay_steps=5,
                      clip_norm=2.0, moment_dtype=moments)
    jcfg = JAdamW(lr=0.1, warmup_steps=2, decay_steps=5, clip_norm=2.0,
                  moment_dtype=moments)
    state = optimizer.init(params, moments)
    jstate = j_opt.init(_j_tree(params), moments)
    for i, gscale in enumerate((3.0, 0.1, 1.0, 10.0)):
        grads = pytree.tree_map(
            lambda s: torch.from_numpy((gscale * rng.standard_normal(s))
                                       .astype(np.float32)), shapes)
        new_p, state, m = optimizer.update(cfg, grads, state,
                                           torch.float32)
        jp, jstate, jm = j_opt.update(jcfg, _j_tree(grads), jstate,
                                      jnp.float32)
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        got = _np_tree(new_p)
        for name, want in pytree.leaves_with_paths(
                jax.tree.map(np.asarray, jp)):
            np.testing.assert_allclose(got[name], want, rtol=1e-6,
                                       atol=1e-6, err_msg=f"{i} {name}")
    assert int(state["count"]) == 4
    assert pytree.leaves(state["m"])[0].dtype == getattr(torch, moments)


def test_checkpoint_roundtrip_and_gc(small_setup, tmp_path):
    cfg, dc, params = small_setup
    state = init_train_state(cfg, params, device=CPU)
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, state)
    assert ck.all_steps() == [3, 4]            # gc keeps last 2
    step, restored = ck.restore(state, device=CPU)
    assert step == 4
    for a, b in zip(pytree.leaves(state), pytree.leaves(restored)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_async_checkpoint(small_setup, tmp_path):
    cfg, dc, params = small_setup
    state = init_train_state(cfg, params, device=CPU)
    ck = Checkpointer(str(tmp_path), keep=2, async_save=True)
    ck.save(10, state)
    ck.wait()
    assert ck.latest_step() == 10


def test_restart_reproduces_run(small_setup, tmp_path):
    """Fault tolerance: train 6 steps; or crash at 3 + restore + 3 more ->
    identical params (deterministic pipeline + checkpoint)."""
    cfg, dc, params = small_setup
    step = make_train_step(cfg, AdamWConfig(lr=1e-3))
    state = init_train_state(cfg, params, device=CPU)
    for i in range(6):
        state, _ = step(state, _step(dc, i))
    ref = pytree.leaves(state["params"])

    ck = Checkpointer(str(tmp_path))
    state2 = init_train_state(cfg, params, device=CPU)
    for i in range(3):
        state2, _ = step(state2, _step(dc, i))
    ck.save(3, state2)
    del state2                                  # "crash"
    _, state3 = ck.restore(init_train_state(cfg, params, device=CPU),
                           device=CPU)
    for i in range(3, 6):
        state3, _ = step(state3, _step(dc, i))
    for a, b in zip(ref, pytree.leaves(state3["params"])):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   atol=1e-6)


def test_train_loop_fail_at_step_matches_uninterrupted(tmp_path):
    """``train_loop`` with an injected failure (restore from the step-4
    checkpoint, redo steps 4-5) ends with the uninterrupted run's params
    within the reference test's atol."""
    cfg = C.get("phi3-mini-3.8b").reduced()
    dc = DataConfig(task="copy", vocab=cfg.vocab, seq_len=32,
                    global_batch=8)
    opt = AdamWConfig(lr=1e-3)
    kw = dict(ckpt_every=4, log_every=100, device=CPU)
    ref = train_cli.train_loop(cfg, dc, opt, 8, Checkpointer(
        str(tmp_path / "a")), **kw)
    got = train_cli.train_loop(cfg, dc, opt, 8, Checkpointer(
        str(tmp_path / "b"), async_save=True), fail_at_step=6, **kw)
    for a, b in zip(pytree.leaves(ref["params"]),
                    pytree.leaves(got["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    # resume: a third loop starts from the latest checkpoint (step 8)
    more = train_cli.train_loop(cfg, dc, opt, 8, Checkpointer(
        str(tmp_path / "b")), **kw)
    assert int(more["opt"]["count"]) == 8


def test_train_cli_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "train", "--steps", "3", "--batch", "4", "--seq", "16",
        "--ckpt-dir", str(tmp_path), "--ckpt-every", "2", "--device", "cpu",
        "--arch", "rwkv6-3b"])
    train_cli.main()
    assert "[train] done" in capsys.readouterr().out
    assert Checkpointer(str(tmp_path)).all_steps() == [2, 3]


def test_bf16_moments_option(small_setup):
    cfg, dc, params = small_setup
    opt = AdamWConfig(lr=1e-3, moment_dtype="bfloat16")
    state = init_train_state(cfg, params, opt, device=CPU)
    assert pytree.leaves(state["opt"]["m"])[0].dtype == torch.bfloat16
    state, m = make_train_step(cfg, opt)(state, _step(dc, 0))
    assert bool(torch.isfinite(m["loss"]))


def test_lr_schedule_shape():
    opt = AdamWConfig(lr=1.0, warmup_steps=10, decay_steps=100,
                      min_lr_ratio=0.1)
    lrs = [float(optimizer.schedule(opt, s))
           for s in (0, 5, 10, 50, 100, 1000)]
    assert lrs[0] == 0.0 and lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert lrs[-1] == pytest.approx(0.1)
    jopt = JAdamW(lr=1.0, warmup_steps=10, decay_steps=100,
                  min_lr_ratio=0.1)
    for s in range(0, 130, 7):
        assert float(optimizer.schedule(opt, s)) == pytest.approx(
            float(j_opt.schedule(jopt, jnp.int32(s))), rel=1e-6, abs=1e-9)


# ------------------------------------------ checkpoints across the packages
def _manifest(d, step):
    with open(os.path.join(d, f"step_{step}", "manifest.json")) as f:
        return json.load(f)


def test_reference_checkpoint_restores_in_the_port(small_setup, tmp_path):
    cfg, dc, params = small_setup
    state = init_train_state(cfg, params, device=CPU)
    jstate = jax.tree.map(jnp.asarray, convert.lm_params_to_numpy(state))
    JCheckpointer(str(tmp_path / "ref")).save(5, jstate)
    JCheckpointer(str(tmp_path / "port")).save(5, jstate)
    Checkpointer(str(tmp_path / "port")).save(5, state)
    step, got = Checkpointer(str(tmp_path / "ref")).restore(state,
                                                           device=CPU)
    assert step == 5
    for (name, a), b in zip(pytree.leaves_with_paths(state),
                            pytree.leaves(got)):
        assert a.dtype == b.dtype, name
        assert torch.equal(a, b), name
    assert _manifest(tmp_path / "ref", 5) == _manifest(tmp_path / "port", 5)


def test_port_checkpoint_restores_in_the_reference(small_setup, tmp_path):
    cfg, dc, params = small_setup
    state = init_train_state(cfg, params, device=CPU)
    state, _ = make_train_step(cfg, AdamWConfig(lr=1e-3))(state,
                                                          _step(dc, 0))
    Checkpointer(str(tmp_path)).save(1, state)
    target = jax.tree.map(jnp.asarray, convert.lm_params_to_numpy(state))
    step, got = JCheckpointer(str(tmp_path)).restore(target)
    assert step == 1
    want = convert.lm_params_to_numpy(state)
    for (name, a), b in zip(pytree.leaves_with_paths(want),
                            jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(b), a, err_msg=name)
        assert np.asarray(b).dtype == a.dtype, name
    names = [a["name"] for a in _manifest(tmp_path, 1)["arrays"]]
    assert names == [n for n, _ in pytree.leaves_with_paths(want)]
    assert "opt/count" in names and "params/blocks/attn/wq" in names


def test_bf16_checkpoint_bytes_match_the_reference(tmp_path):
    """A bfloat16 leaf is written as the reference writes it (its two raw
    bytes, ``bfloat16`` in the manifest), and the port reads the
    reference's back bit for bit.  (The reference cannot read raw
    two-byte arrays back itself, so the other direction is the byte
    check.)"""
    t = torch.randn(3, 5).to(torch.bfloat16)
    state = {"p": {"w": t}, "count": torch.tensor(3, dtype=torch.int32)}
    jstate = {"p": {"w": jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16)}, "count": jnp.int32(3)}
    JCheckpointer(str(tmp_path / "ref")).save(1, jstate)
    Checkpointer(str(tmp_path / "port")).save(1, state)
    assert _manifest(tmp_path / "ref", 1) == _manifest(tmp_path / "port", 1)
    with np.load(tmp_path / "ref" / "step_1" / "arrays.npz") as r, \
            np.load(tmp_path / "port" / "step_1" / "arrays.npz") as p:
        assert r["p/w"].tobytes() == p["p/w"].tobytes()
        assert r["p/w"].dtype == p["p/w"].dtype
    _, got = Checkpointer(str(tmp_path / "ref")).restore(state, device=CPU)
    assert got["p"]["w"].dtype == torch.bfloat16
    assert torch.equal(got["p"]["w"], t)
