"""The port's LM substrate against the JAX reference, on the CPU.

For every arch of the registry, reduced: the same numpy weights (the
port's ``init_params`` taken to numpy through ``convert``) and the same
numpy batch go through ``repro`` and ``repro_torch``.  Forward logits and
aux, the loss and every per-leaf grad, one full train step and prefill
plus decode logits agree within the tolerances stated beside each check
(float32 throughout: the sums run in another order, nothing else
differs).  Then the twins of ``tests/test_models.py`` on the port alone.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import (decode_step as j_decode, forward as j_forward,
                          init_params as j_init, prefill as j_prefill)
from repro.models import moe as j_moe
from repro.train import AdamWConfig as JAdamW, loss_fn as j_loss
from repro.train import optimizer as j_opt

import repro_torch.configs as C
from repro_torch import convert, pytree
from repro_torch.models import (decode_step, forward, init_params, moe,
                                prefill)
from repro_torch.train import (AdamWConfig, init_train_state,
                               make_train_step)

ARCHS = C.list_archs()
B, S = 2, 40          # 40 > gemma3's reduced window (32) and pads mamba2
N_DECODE = 3
# float32 against float32: logits are O(4), grads O(1e-2..1); the
# differences are summation order only
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-3, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The reduced models' ops are tiny: one intra-op thread runs them as
    fast, and keeps parallel test workers from oversubscribing the
    host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_batch(cfg, b=B, s=S, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    media = (rng.standard_normal((b, cfg.n_media_tokens, cfg.d_model))
             .astype(np.float32) if cfg.n_media_tokens else None)
    return toks, media


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """Reference results for one arch from the port's seed-0 weights."""
    arch = request.param
    cfg, rcfg = C.get(arch).reduced(), RC.get(arch).reduced()
    params = init_params(cfg, 0, device="cpu")
    npp = convert.lm_params_to_numpy(params)
    jp = jax.tree.map(jnp.asarray, npp)
    toks, media = _np_batch(cfg)

    def loss_and_logits(p):
        logits, aux, _ = j_forward(rcfg, p, _j(toks), _j(media))
        loss, _ = j_loss(rcfg, p, _j(toks), _j(media))
        return loss, (logits, aux)
    (loss, (logits, aux)), grads = jax.jit(
        jax.value_and_grad(loss_and_logits, has_aux=True))(jp)
    opt = JAdamW(lr=1e-3)
    new_params, _, metrics = j_opt.update(
        opt, grads, j_opt.init(jp, opt.moment_dtype), jnp.float32)
    s0 = S - N_DECODE
    last, cache = j_prefill(rcfg, jp, _j(toks[:, :s0]), _j(media),
                            max_len=S)
    dec = [last]
    step = jax.jit(lambda c, t: j_decode(rcfg, jp, c, t))
    for t in range(s0, S):
        lg, cache = step(cache, _j(toks[:, t]))
        dec.append(lg)
    as_np = lambda tree: jax.tree.map(np.asarray, tree)
    return dict(arch=arch, cfg=cfg, params=params, npp=npp, toks=toks,
                media=media, logits=np.asarray(logits), aux=float(aux),
                loss=float(loss), grads=as_np(grads),
                new_params=as_np(new_params),
                grad_norm=float(metrics["grad_norm"]),
                decode=[np.asarray(x) for x in dec])


# ------------------------------------------------- parity with the reference
def test_forward_matches_reference(case):
    cfg = case["cfg"]
    logits, aux, _ = forward(cfg, case["params"], _t(case["toks"]),
                             _t(case["media"]))
    np.testing.assert_allclose(logits.numpy(), case["logits"], **LOGIT_TOL)
    assert float(aux) == pytest.approx(case["aux"], rel=1e-5, abs=1e-7)


def test_loss_and_grads_match_reference(case):
    from repro_torch.train.train_step import grads_of
    loss, _, grads = grads_of(case["cfg"], case["params"],
                              _t(case["toks"]), _t(case["media"]))
    assert float(loss) == pytest.approx(case["loss"], rel=1e-5)
    got = dict(pytree.leaves_with_paths(convert.lm_params_to_numpy(grads)))
    want = dict(pytree.leaves_with_paths(case["grads"]))
    assert got.keys() == want.keys()
    for name, g in want.items():
        np.testing.assert_allclose(got[name], g, err_msg=name, **GRAD_TOL)


def test_train_step_matches_reference(case):
    """One full step (grads, clipping, AdamW from a fresh state) lands on
    the reference's params.  Adam's first step is lr·g/(|g| + eps): a
    leaf whose grad is within eps of 0 moves by a fraction of lr that a
    1e-7 grad difference changes, so the tolerance is a tenth of lr."""
    cfg = case["cfg"]
    state = init_train_state(cfg, case["params"], device="cpu")
    batch = {"tokens": _t(case["toks"])}
    if case["media"] is not None:
        batch["media"] = _t(case["media"])
    state, metrics = make_train_step(cfg, AdamWConfig(lr=1e-3))(state, batch)
    assert float(metrics["grad_norm"]) == pytest.approx(case["grad_norm"],
                                                        rel=1e-4)
    got = dict(pytree.leaves_with_paths(
        convert.lm_params_to_numpy(state["params"])))
    for name, p in pytree.leaves_with_paths(case["new_params"]):
        np.testing.assert_allclose(got[name], p, rtol=0, atol=1e-4,
                                   err_msg=name)


def test_decode_matches_reference(case):
    cfg, toks = case["cfg"], case["toks"]
    s0 = S - N_DECODE
    last, cache = prefill(cfg, case["params"], _t(toks[:, :s0]),
                          _t(case["media"]), max_len=S)
    got = [last]
    for t in range(s0, S):
        lg, cache = decode_step(cfg, case["params"], cache,
                                _t(toks[:, t]))
        got.append(lg)
    for g, w in zip(got, case["decode"]):
        np.testing.assert_allclose(g.numpy(), w, **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_names_shapes_dtypes(arch):
    """The port's params are laid out as the reference's: same paths,
    stacked shapes and dtypes (full widths, so no reference compute)."""
    cfg = C.get(arch).reduced()
    ref = jax.eval_shape(lambda: j_init(RC.get(arch).reduced(),
                                        jax.random.PRNGKey(0)))
    want = {n: (tuple(a.shape), str(a.dtype))
            for n, a in pytree.leaves_with_paths(ref)}
    got = {n: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for n, t in pytree.leaves_with_paths(
               init_params(cfg, 0, device="cpu"))}
    assert got == want


def test_moe_routing_ties_go_to_the_lower_expert():
    """Equal router probabilities pick the lower expert index, as
    ``jax.lax.top_k`` does: ``top_i`` equal first, then the outputs."""
    cfg = C.get("dbrx-132b").reduced()
    rcfg = RC.get("dbrx-132b").reduced()
    p = pytree.tree_map(lambda t: t[0],
                        init_params(cfg, 0, device="cpu")["blocks"]["ffn"])
    router = p["router"].clone()
    router[:, 3] = router[:, 0]            # experts 0 and 3 always tie
    router[:, 2] = router[:, 1]            # and so do 1 and 2
    p["router"] = router
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    _, _, top_i = moe.route(router, x.reshape(1, 32, -1), 2)
    jprobs = jax.nn.softmax(jnp.asarray(x.numpy()).reshape(1, 32, -1)
                            @ jnp.asarray(router.numpy()), axis=-1)
    _, j_top_i = jax.lax.top_k(jprobs, 2)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(j_top_i))
    y, aux = moe.moe_forward(p, cfg, x)
    jy, jaux = j_moe.moe_forward(
        jax.tree.map(lambda t: jnp.asarray(t.numpy()), p), rcfg,
        jnp.asarray(x.numpy()))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)


@pytest.mark.parametrize("cap", [0.5, 1.0])
def test_moe_capacity_drops_match_reference(cap):
    """Past capacity the same (token, k) choices drop in both."""
    cfg = dataclasses.replace(C.get("deepseek-v2-236b").reduced(),
                              capacity_factor=cap)
    rcfg = dataclasses.replace(RC.get("deepseek-v2-236b").reduced(),
                               capacity_factor=cap)
    p = pytree.tree_map(lambda t: t[0],
                        init_params(cfg, 0, device="cpu")["blocks"]["ffn"])
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32))
    y, aux = moe.moe_forward(p, cfg, x, group_size=32)
    jy, jaux = j_moe.moe_forward(
        jax.tree.map(lambda t: jnp.asarray(t.numpy()), p), rcfg,
        jnp.asarray(x.numpy()), group_size=32)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "gemma3-27b",
                                  "deepseek-v2-236b"])
def test_chunked_prefill_matches_reference(arch):
    """Query-block chunking (``q_chunk`` below S) against the reference's
    chunked pass on the same weights."""
    cfg = C.get(arch).reduced()
    params = init_params(cfg, 1, device="cpu")
    jp = jax.tree.map(jnp.asarray, convert.lm_params_to_numpy(params))
    toks, media = _np_batch(cfg, s=64, seed=3)
    got, _, _ = forward(cfg, params, _t(toks), _t(media), q_chunk=16)
    want, _, _ = j_forward(RC.get(arch).reduced(), jp, _j(toks), _j(media),
                           q_chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


@pytest.mark.parametrize("policy", ["", "dots"])
def test_remat_keeps_loss_and_grads(policy):
    """Checkpointed layers (whole, or saving only the matmuls) give the
    grads of the plain pass, to the last bit the recompute allows."""
    from repro_torch.train.train_step import grads_of
    cfg = C.get("deepseek-v2-236b").reduced()
    params = init_params(cfg, 0, device="cpu")
    toks, _ = _np_batch(cfg, s=16)
    l0, _, g0 = grads_of(cfg, params, _t(toks))
    l1, _, g1 = grads_of(cfg, params, _t(toks), remat=True,
                         remat_policy=policy)
    assert float(l0) == float(l1)
    for (n, a), b in zip(pytree.leaves_with_paths(g0), pytree.leaves(g1)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8, msg=n)


# ------------------------------------------------ twins of test_models.py
def _batch(cfg, b=2, s=32):
    toks, media = _np_batch(cfg, b, s)
    return _t(toks), _t(media)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_smoke(arch):
    cfg = C.get(arch).reduced()
    params = init_params(cfg, 0, device="cpu")
    toks, media = _batch(cfg)
    logits, aux, _ = forward(cfg, params, toks, media)
    assert logits.shape == (2, 32, cfg.vocab)
    assert bool(torch.isfinite(logits).all()), f"{arch}: NaN/inf in logits"
    assert bool(torch.isfinite(aux))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_smoke(arch):
    cfg = C.get(arch).reduced()
    params = init_params(cfg, 0, device="cpu")
    state = init_train_state(cfg, params, device="cpu")
    step = make_train_step(cfg, AdamWConfig(lr=1e-3))
    toks, media = _batch(cfg)
    batch = {"tokens": toks}
    if media is not None:
        batch["media"] = media
    state, metrics = step(state, batch)
    assert bool(torch.isfinite(metrics["loss"]))
    assert bool(torch.isfinite(metrics["grad_norm"]))
    # params actually changed
    before = pytree.leaves(params)[0]
    after = pytree.leaves(state["params"])[0]
    assert not torch.allclose(before, after)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    cfg = C.get(arch).reduced()
    params = init_params(cfg, 0, device="cpu")
    b, s = 2, 16
    toks, media = _batch(cfg, b, s + 3)
    full, _, _ = forward(cfg, params, toks, media)
    last, cache = prefill(cfg, params, toks[:, :s], media, max_len=s + 3)
    errs = [float((last - full[:, s - 1]).abs().max())]
    for t in range(s, s + 3):
        lg, cache = decode_step(cfg, params, cache, toks[:, t])
        errs.append(float((lg - full[:, t]).abs().max()))
    assert max(errs) < 5e-3, f"{arch}: decode drifts {max(errs)}"


def test_rwkv_chunked_equals_scan():
    cfg = C.get("rwkv6-3b").reduced()
    params = init_params(cfg, 0, device="cpu")
    toks = _t(np.random.default_rng(0).integers(0, cfg.vocab, (2, 64)))
    a, _, _ = forward(cfg, params, toks, rwkv_chunked=False)
    b, _, _ = forward(cfg, params, toks, rwkv_chunked=True)
    assert float((a - b).abs().max()) < 1e-4


def test_rwkv_chunked_matches_reference():
    cfg = C.get("rwkv6-3b").reduced()
    params = init_params(cfg, 2, device="cpu")
    jp = jax.tree.map(jnp.asarray, convert.lm_params_to_numpy(params))
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 64))
    got, _, _ = forward(cfg, params, _t(toks), rwkv_chunked=True)
    want, _, _ = j_forward(RC.get("rwkv6-3b").reduced(), jp, _j(toks),
                           rwkv_chunked=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_mamba_chunk_invariance():
    cfg = C.get("zamba2-1.2b").reduced()
    params = init_params(cfg, 0, device="cpu")
    toks = _t(np.random.default_rng(0).integers(0, cfg.vocab, (2, 32)))
    a, _, _ = forward(cfg, params, toks)
    cfg2 = dataclasses.replace(cfg, ssm_chunk=8)
    b, _, _ = forward(cfg2, params, toks)
    assert float((a - b).abs().max()) < 1e-4


def test_gemma3_local_global_striping():
    from repro_torch.models.transformer import layer_flags
    cfg = C.get("gemma3-27b")
    use_window, thetas = layer_flags(cfg)
    uw = use_window.numpy()
    # globals at layer idx % 6 == 5 -> 10 of 62; the rest local
    assert uw.sum() == 62 - 10
    assert not uw[5] and uw[0]          # every 6th layer is global
    th = thetas.numpy()
    assert th[5] == 1_000_000.0 and th[0] == 10_000.0
    from repro.models.transformer import layer_flags as j_flags
    j_uw, j_th = j_flags(RC.get("gemma3-27b"))
    np.testing.assert_array_equal(uw, np.asarray(j_uw))
    np.testing.assert_array_equal(th, np.asarray(j_th))


def test_moe_capacity_drops_tokens():
    """With a tight capacity factor, the MoE drops tokens (and stays
    finite) — the large-scale configuration."""
    cfg = dataclasses.replace(C.get("dbrx-132b").reduced(),
                              capacity_factor=0.5)
    params = init_params(cfg, 0, device="cpu")
    toks, _ = _batch(cfg)
    logits, aux, _ = forward(cfg, params, toks)
    assert bool(torch.isfinite(logits).all())


def test_media_injection_changes_output():
    cfg = C.get("phi-3-vision-4.2b").reduced()
    params = init_params(cfg, 0, device="cpu")
    toks, media = _batch(cfg)
    a, _, _ = forward(cfg, params, toks, media)
    b, _, _ = forward(cfg, params, toks, media * 2.0)
    assert float((a - b).abs().max()) > 0  # frontend stub is live


def test_param_count_tracks_config():
    for arch in ("phi3-mini-3.8b", "dbrx-132b", "deepseek-v2-236b",
                 "gemma3-27b"):
        cfg = C.get(arch)
        n = cfg.n_params()
        expect = {"phi3-mini-3.8b": 3.8e9, "dbrx-132b": 132e9,
                  "deepseek-v2-236b": 236e9, "gemma3-27b": 27e9}[arch]
        assert 0.6 * expect < n < 1.45 * expect, (arch, n, expect)
        assert cfg.n_active_params() <= n
        assert n == RC.get(arch).n_params()
        assert cfg.n_active_params() == RC.get(arch).n_active_params()


def test_registry_matches_reference():
    assert C.list_archs() == RC.list_archs()
    for arch in C.list_archs():
        assert (dataclasses.asdict(C.get(arch).reduced())
                == dataclasses.asdict(RC.get(arch).reduced()))
        assert dataclasses.asdict(C.get(arch)) == dataclasses.asdict(
            RC.get(arch))
    assert dataclasses.asdict(C.TDR_GRAPH) == dataclasses.asdict(
        RC.TDR_GRAPH)
    assert {k: dataclasses.asdict(v) for k, v in C.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in RC.SHAPES.items()}
