"""The torch port's training path (``repro_torch.optim``, ``data``,
``train``, the models' backward) against the JAX package's, on the CPU.

The same numpy-seeded inputs go through the JAX function in process and
through its counterpart on ``device="cpu"``; the JAX package's own
initialised parameters and optimizer state are carried across by
``repro_torch.convert.train_state_from_numpy`` and compared, restacked, by
``train_state_to_numpy``.

Tolerances, and why:

* schedules — 1e-7 relative (float32 arithmetic in the reference's order).
* ``adamw_update`` given the same gradients — parameters, ``m`` and ``v``
  within 1e-6 of each leaf's largest magnitude, ``global_norm`` within
  1e-6 relative: the reference sums the squares per stacked leaf, the
  port per layer.  bfloat16 parameters: within one bfloat16 step of the
  reference's (a float32 ulp before the cast can round the other way), and
  the norm of bfloat16 gradients within 2e-6: the reference's float32 sum
  of their squares falls 1.4-1.6e-6 short of the float64 sum (qwen3-4b
  smoke, three seeds), the port's within 5e-8 of it; so the clip scale
  differs by as much, and ``m`` and ``v`` (its square) are held within
  4e-6 there.
* the data pipeline — byte for byte (the same numpy code).
* one train step — ``loss``, ``ce``, ``aux``, ``grad_norm`` within 1e-5
  relative, each ``m`` and ``v`` leaf within 1e-4 of its largest magnitude
  (float32 matmuls summed in other orders), and each parameter within
  1e-4 of its leaf's largest magnitude plus ``STEP_LR`` x the learning
  rate.  AdamW's first step is g / (|g| + eps): a gradient near eps = 1e-8
  (``m`` of 2e-9 in granite-moe's ``wo``, internvl2's ``w_down``) turns
  its relative error into a step anywhere in (-1, 1), and a gradient under
  the summation noise turns its sign into +-lr.  So a parameter whose
  clipped gradient (``sqrt(v / (1 - b2))`` of the reference's ``v``) is
  below ``SMALL_GRAD`` of its leaf's largest may differ by up to twice the
  learning rate.  That holds where every int8 code
  and MoE expert choice of the two packages agrees (recorded as
  ``tests/test_torch_models.py`` records them).  Where a fake-quant code
  flipped (one step, at most 1% of a call's codes) or a near-tie expert
  choice differs, the flip is printed and the step is held within
  ``FLIP_LOSS`` relative, each moment leaf within ``FLIP_MOMENT`` of its
  largest magnitude, and each parameter within ``FLIP_PARAM`` of its
  leaf's largest magnitude plus ``STEP_LR`` learning rates, or two where
  the reference's clipped gradient is below ``FLIP_MOMENT`` of its leaf's
  largest: a flipped activation moves the gradients of the rows it feeds
  by that much, which can turn a smaller gradient's sign (RWKV6's LoRA
  ``wA``, initialised at 0.01, on the card against the CPU).
* the reference's own training contracts (``tests/test_training.py``) on
  the port: the same bounds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as JMOE
import repro.quant.quantizers as JQ
from repro.configs import smoke_config as jax_smoke_config
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticCorpus as JSyntheticCorpus
from repro.models import get_model as jax_get_model
from repro.optim import adamw as JA
from repro.optim import schedules as JS
from repro.parallel.logical import split_logical
from repro.parallel.sharding import MESH_RULES
from repro.train.step import make_train_step as jax_make_train_step

import repro_torch.models.moe as TMOE
import repro_torch.quant.quantizers as TQ
from repro_torch.configs import smoke_config
from repro_torch.convert import (reference_leaf_rank, train_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.data import DataConfig, SyntheticCorpus, host_sharded_loader
from repro_torch.models import get_model
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               constant_lr, cosine_schedule, global_norm,
                               linear_warmup_cosine)
from repro_torch.train import (AUX_COEF, init_train_state, make_loss_fn,
                               make_train_step)
from torch_expert_choices import expert_flip

SEED = 0
ARCHS = ("qwen3-4b", "llama3.2-3b", "phi3-mini-3.8b", "mistral-large-123b",
         "internvl2-1b", "whisper-tiny", "granite-moe-1b-a400m",
         "granite-moe-3b-a800m", "rwkv6-7b", "zamba2-1.2b")
MICRO_ARCHS = ("llama3.2-3b", "granite-moe-1b-a400m", "rwkv6-7b",
               "zamba2-1.2b")
B, S = 8, 16            # 128 tokens: one MoE group; 32 per 4-way microbatch
LR = 1e-3
EXPERT_TIE = 1e-6
FLIP_CODES = 0.01
STEP_LOSS = 1e-5
STEP_LEAF = 1e-4
STEP_LR = 0.1
SMALL_GRAD = 1e-3
FLIP_LOSS = 1e-3
FLIP_PARAM = 0.01
FLIP_MOMENT = 0.05



@pytest.fixture(autouse=True)
def one_thread():
    """torch on one CPU thread in these tests (restored after each): their
    tensors are tiny, and with the suite's parallel workers sharing the
    cores, multi-threaded kernels on them spin far longer than they
    compute."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def ref_setup(arch, **replace):
    """The JAX package's smoke config, model API and parameters (key
    SEED)."""
    cfg = jax_smoke_config(arch).replace(**replace)
    api = jax_get_model(cfg)
    params, _ = split_logical(api.init_params(jax.random.PRNGKey(SEED)),
                              MESH_RULES)
    return cfg, api, params


def corpus_of(cfg, b=B, s=S):
    fr = cfg.frontend
    return SyntheticCorpus(DataConfig(
        vocab=cfg.vocab, seq_len=s, global_batch=b,
        frontend_tokens=fr.n_tokens if fr else 0,
        frontend_dim=fr.d_frontend if fr else 0))


def host(tree):
    """A JAX tree's leaves as numpy."""
    return jax.tree.map(np.asarray, tree)


def f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).numpy()
    return np.asarray(np.asarray(x).astype(np.float32), dtype=np.float64)


def leaf_errors(want, got) -> list[tuple[float, str]]:
    """(max |diff| / max |want|, path) per leaf of two ``(params,
    opt_state)`` trees of one structure."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(want)
    got_leaves = jax.tree.leaves(got)
    assert len(got_leaves) == len(flat)
    out = []
    for (path, a), b in zip(flat, got_leaves):
        a, b = f64(a), f64(b)
        assert a.shape == b.shape, (jax.tree_util.keystr(path), a.shape,
                                    b.shape)
        out.append((np.abs(a - b).max() / max(np.abs(a).max(), 1e-30),
                    jax.tree_util.keystr(path)))
    return out


def param_bound(p: np.ndarray, v: np.ndarray, flip: bool) -> np.ndarray:
    """Per element, how far one step's parameter may lie from the
    reference's ``p`` (module doc): a share of the leaf's largest magnitude
    plus ``STEP_LR`` learning rates, or two where the reference's clipped
    gradient (from its ``v``) is small against the leaf's largest."""
    leaf, small = (FLIP_PARAM, FLIP_MOMENT) if flip else (STEP_LEAF,
                                                          SMALL_GRAD)
    g = np.sqrt(v / (1 - 0.95))
    return leaf * np.abs(p).max() + LR * np.where(g < small * g.max(), 2.0,
                                                  STEP_LR)


def _assert_params_close(want_state, got_state, what, flip: bool) -> None:
    for a, b, v in zip(jax.tree.leaves(want_state[0]),
                       jax.tree.leaves(got_state[0]),
                       jax.tree.leaves(want_state[1]["v"])):
        a, b = f64(a), f64(b)
        assert np.all(np.abs(a - b) <= param_bound(a, f64(v), flip)), what


def rel(a, b) -> float:
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(a), 1e-30)


# ---------------------------------------------------------------------------
# int8 codes and expert choices of both packages, inside the train step
# ---------------------------------------------------------------------------


@pytest.fixture
def rec(monkeypatch):
    """Record every ``quantize_int`` code array and MoE dispatch's expert
    choices both packages compute in a train step.  JAX's come through an
    ordered debug callback (its rematerialised blocks do not record
    again); the port's are split into the forward pass and the
    recomputation that ``torch.utils.checkpoint`` runs inside the backward
    pass (``re``)."""
    rec = {"jax": [], "port": [], "re": [],
           "experts": {"jax": [], "port": [], "re": []}}
    jax_q, port_q = JQ.quantize_int, TQ.quantize_int
    jax_d, port_d = JMOE._top_k_dispatch, TMOE._top_k_dispatch

    def phase() -> str:
        return "port" if torch._C._current_graph_task_id() == -1 else "re"

    def jax_rec(*a, **k):
        q, s = jax_q(*a, **k)
        jax.debug.callback(lambda v: rec["jax"].append(np.asarray(v)), q,
                           ordered=True)
        return q, s

    def port_rec(*a, **k):
        q, s = port_q(*a, **k)
        rec[phase()].append(q.numpy().copy())
        return q, s

    def jax_dispatch(gates, k, capacity):
        jax.debug.callback(
            lambda g, i: rec["experts"]["jax"].append(
                (np.asarray(g), np.asarray(i))),
            gates, jax.lax.top_k(gates, k)[1], ordered=True)
        return jax_d(gates, k, capacity)

    def port_dispatch(gates, k, capacity):
        rec["experts"][phase()].append(
            (gates.detach().numpy().copy(), TMOE._top_k(gates, k)[1].numpy()))
        return port_d(gates, k, capacity)

    monkeypatch.setattr(JQ, "quantize_int", jax_rec)
    monkeypatch.setattr(TQ, "quantize_int", port_rec)
    monkeypatch.setattr(JMOE, "_top_k_dispatch", jax_dispatch)
    monkeypatch.setattr(TMOE, "_top_k_dispatch", port_dispatch)
    return rec


def _key(a: np.ndarray):
    return a.shape, a.tobytes()


def _distinct(dispatches: list) -> list:
    """The dispatches in call order, each (gates, experts) once: a JAX
    microbatch scan under remat may run its callback twice for one
    dispatch."""
    seen, out = set(), []
    for gates, experts in dispatches:
        key = _key(gates) + _key(experts)
        if key not in seen:
            seen.add(key)
            out.append((gates, experts))
    return out


def first_flip(rec):
    """None where every int8 code array of the reference's forward pass is
    one the port computed, and every expert choice agrees; else (what,
    count, size) of the first difference, printed.

    The code arrays are compared as sets: under ``grad`` and remat the JAX
    trace may merge two quantizations of one tensor (whisper's cross
    attention K and V quantize the encoder output alike) and order calls
    otherwise.  A code array of the reference's that the port lacks must
    have a counterpart of its shape in the port's that differs by one step
    in at most ``FLIP_CODES`` of its codes."""
    jax.effects_barrier()
    assert rec["jax"] and rec["port"]
    want = {_key(a): a for a in rec["jax"]}
    got = {_key(a): a for a in rec["port"]}
    missing = [k for k in want if k not in got]
    if missing:
        a = want[missing[0]]
        diffs = [np.abs(a.astype(np.int32) - b.astype(np.int32))
                 for k, b in got.items() if k[0] == a.shape and k not in want]
        assert diffs, f"no port code array of shape {a.shape}"
        d = min(diffs, key=lambda d: int((d > 0).sum()))
        flips = int((d > 0).sum())
        assert d.max() == 1 and flips <= FLIP_CODES * d.size, (
            d.max(), flips, d.size)
        print(f"fake-quant flip: {len(missing)} code arrays differ, the "
              f"first by {flips} of {d.size} codes")
        return "codes", flips, d.size
    ex = rec["experts"]
    flip = expert_flip(_distinct(ex["port"]), _distinct(ex["jax"]),
                       EXPERT_TIE)
    if flip is not None:
        print(f"expert flip: dispatch {flip[0]}, {flip[1]} of {flip[2]} "
              "tokens routed otherwise")
        return ("experts",) + flip[1:]
    return None


def assert_recomputed_alike(rec) -> None:
    """Every fake-quant the backward pass recomputed (remat) gave codes the
    forward pass gave, and so every expert choice."""
    fwd = {_key(a) for a in rec["port"]}
    assert rec["re"], "nothing was rematerialised"
    assert all(_key(a) in fwd for a in rec["re"])
    fwd_ex = {_key(i) for _, i in rec["experts"]["port"]}
    assert all(_key(i) in fwd_ex for _, i in rec["experts"]["re"])


def jax_step(arch, microbatches=1, **replace):
    """One jitted reference step from its initial state; returns (cfg,
    initial (params, opt) as numpy, batch, new (params, opt) as numpy,
    metrics)."""
    cfg, api, params = ref_setup(arch, **replace)
    opt = JA.adamw_init(params)
    batch = corpus_of(cfg).batch(0)
    state0 = host((params, opt))
    step = jax.jit(jax_make_train_step(api, JS.constant_lr(LR),
                                       microbatches=microbatches))
    p, o, m = step(params, opt, {k: jnp.asarray(v) for k, v in batch.items()})
    return cfg, state0, batch, host((p, o)), {k: float(v) for k, v in
                                             m.items()}


def port_step(arch, state0, batch, microbatches=1, **replace):
    cfg = smoke_config(arch).replace(**replace)
    model, opt = train_state_from_numpy(cfg, state0, device="cpu")
    step = make_train_step(get_model(cfg), constant_lr(LR),
                           microbatches=microbatches)
    model, opt, m = step(model, opt, batch)
    return train_state_to_numpy(cfg, model, opt), m


def assert_step_close(want_state, want_m, got_state, got_m, flip,
                      what: str) -> None:
    errs = leaf_errors(want_state, got_state)
    for key in ("loss", "ce", "aux", "grad_norm", "lr"):
        assert got_m[key].shape == () and got_m[key].dtype == torch.float32
    if flip is None:
        for key in ("loss", "ce", "aux", "grad_norm", "lr"):
            assert rel(want_m[key], got_m[key]) <= STEP_LOSS, (
                what, key, want_m[key], float(got_m[key]))
        for err, path in errs:
            if not path.startswith("[0]"):
                assert err <= STEP_LEAF, (what, path, err)
        _assert_params_close(want_state, got_state, what, flip=False)
        return
    for key in ("loss", "ce", "grad_norm", "lr"):
        assert rel(want_m[key], got_m[key]) <= FLIP_LOSS, (
            what, key, want_m[key], float(got_m[key]))
    assert abs(want_m["aux"] - float(got_m["aux"])) <= FLIP_LOSS * max(
        abs(want_m["aux"]), 1.0)
    for err, path in errs:
        if not path.startswith("[0]"):
            assert err <= FLIP_MOMENT, (what, path, err)
    _assert_params_close(want_state, got_state, what, flip=True)
    print(f"{what}: {flip}; loss {want_m['loss']!r} / {float(got_m['loss'])!r};"
          f" worst leaf {max(errs)}")


# ---------------------------------------------------------------------------
# 1. schedules
# ---------------------------------------------------------------------------

SCHEDULES = {
    "constant_lr": (1e-3,),
    "cosine_schedule": (2.0, 37),
    "linear_warmup_cosine": (3e-4, 7, 40),
}


class TestSchedules:
    @pytest.mark.parametrize("name", sorted(SCHEDULES))
    def test_schedule_matches_the_reference(self, name):
        args = SCHEDULES[name]
        want_f = getattr(JS, name)(*args)
        got_f = {"constant_lr": constant_lr, "cosine_schedule":
                 cosine_schedule, "linear_warmup_cosine":
                 linear_warmup_cosine}[name](*args)
        for step in range(51):
            want = float(want_f(jnp.asarray(step, jnp.int32)))
            got = got_f(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32 and got.shape == ()
            assert abs(got.item() - want) <= 1e-7 * abs(want), (step, want,
                                                                got.item())

    def test_reference_schedule_contract(self):
        s = linear_warmup_cosine(1.0, warmup=10, total_steps=100)
        assert float(s(0)) == 0.0
        assert float(s(10)) == pytest.approx(1.0, abs=1e-3)
        assert float(s(100)) < float(s(50))
        c = cosine_schedule(2.0, 100)
        assert float(c(0)) == pytest.approx(2.0)

    def test_schedule_follows_the_step_device(self):
        step = torch.tensor(3, dtype=torch.int32, device="meta")
        assert linear_warmup_cosine(1.0, 5, 10)(step).device.type == "meta"


# ---------------------------------------------------------------------------
# 2. AdamW
# ---------------------------------------------------------------------------


def _grads_like(tree, seed):
    """Normal gradients shaped like a reference parameter tree (numpy,
    the leaves' dtypes), seeded."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: np.asarray(jnp.asarray(
            rng.normal(size=p.shape).astype(np.float32)).astype(p.dtype)),
        tree)


def _port_grads(cfg, model, grads_tree):
    """A reference gradient tree as the port's ``{name: tensor}``, by the
    same unstacking as the parameters."""
    from repro_torch.convert import _reference_names, _tensor_from_numpy

    out = {}
    for name, (ref, index) in _reference_names(model).items():
        leaf = grads_tree
        for key in ref.split("."):
            leaf = leaf[key]
        leaf = leaf if index is None else leaf[index]
        p = dict(model.named_parameters())[name]
        out[name] = _tensor_from_numpy(leaf, p.dtype, p.device)
    return out


class TestAdamW:
    @pytest.mark.parametrize("arch,dtype", [
        ("llama3.2-3b", "float32"), ("rwkv6-7b", "float32"),
        ("zamba2-1.2b", "float32"), ("whisper-tiny", "float32"),
        ("qwen3-4b", "bfloat16")])
    def test_update_matches_the_reference(self, arch, dtype):
        replace = dict(param_dtype=dtype, compute_dtype=dtype)
        cfg_j, _, params = ref_setup(arch, **replace)
        opt = JA.adamw_init(params)
        # a second step, so the bias corrections and moments are not the
        # first step's trivial ones
        g1, g2 = _grads_like(params, 1), _grads_like(params, 2)
        lr = jnp.float32(3e-3)
        update = jax.jit(JA.adamw_update)
        p1, o1, _ = update(jax.tree.map(jnp.asarray, g1), opt, params, lr)
        p2, o2, m2 = update(jax.tree.map(jnp.asarray, g2), o1, p1, lr)
        cfg = smoke_config(arch).replace(**replace)
        model, st = train_state_from_numpy(cfg, host((params, opt)),
                                           device="cpu")
        names = dict(model.named_parameters())
        decay = {n: reference_leaf_rank(n, p.ndim) >= 2
                 for n, p in names.items()}
        lr_t = torch.tensor(3e-3)
        for g in (g1, g2):
            _, st, m = adamw_update(_port_grads(cfg, model, g), st, names,
                                    lr_t, decay=decay)
        norm_tol = 2e-6 if dtype == "bfloat16" else 1e-6
        assert rel(m2["grad_norm"], m["grad_norm"]) <= norm_tol
        got = train_state_to_numpy(cfg, model, st)
        want = host((p2, o2))
        assert int(got[1]["count"]) == 2
        for err, path in leaf_errors(want, got):
            if path.startswith("[0]") and dtype == "bfloat16":
                continue
            assert err <= (4e-6 if dtype == "bfloat16" else 1e-6), (path,
                                                                    err)
        if dtype == "bfloat16":
            for a, b in zip(jax.tree.leaves(want[0]),
                            jax.tree.leaves(got[0])):
                if a.dtype.name != "bfloat16":   # the float32 norm gains
                    assert np.abs(f64(a) - f64(b)).max() <= 1e-6 * np.abs(
                        f64(a)).max()
                    continue
                a = np.asarray(a).view(np.int16).astype(np.int32)
                b = b.view(torch.int16).numpy().astype(np.int32)
                assert np.abs(a - b).max() <= 1

    def test_global_norm_matches_the_reference(self):
        _, _, params = ref_setup("zamba2-1.2b")
        g = _grads_like(params, 3)
        want = float(JA.global_norm(jax.tree.map(jnp.asarray, g)))
        cfg = smoke_config("zamba2-1.2b")
        model, _ = train_state_from_numpy(cfg, host((params,
                                                     JA.adamw_init(params))),
                                          device="cpu")
        got = global_norm(_port_grads(cfg, model, g))
        assert got.dtype == torch.float32
        assert rel(want, got) <= 1e-6

    @pytest.mark.parametrize("arch,name,decays", [
        ("llama3.2-3b", "blocks.0.ln_attn.g", True),    # stacked (L, d)
        ("llama3.2-3b", "ln_f.g", False),
        ("llama3.2-3b", "blocks.1.attn.wq.w", True),
        ("whisper-tiny", "enc_blocks.1.ln_mlp.g", True),
        ("whisper-tiny", "enc_ln_f.g", False),
        ("rwkv6-7b", "blocks.0.u", True),
        ("rwkv6-7b", "blocks.1.mu_r", True),
        ("rwkv6-7b", "blocks.0.w0", True),
        ("zamba2-1.2b", "mamba.2.A_log", True),
        ("zamba2-1.2b", "mamba.0.D", True),
        ("zamba2-1.2b", "shared_attn.ln_attn.g", False),
    ])
    def test_decay_follows_the_reference_leaf_rank(self, arch, name, decays):
        # zero gradients: m = v = 0, so a parameter moves only by decay
        cfg = smoke_config(arch)
        model, opt = init_train_state(get_model(cfg), device="cpu")
        params = dict(model.named_parameters())
        before = params[name].detach().clone()
        grads = {n: torch.zeros_like(p) for n, p in params.items()}
        decay = {n: reference_leaf_rank(n, p.ndim) >= 2
                 for n, p in params.items()}
        lr = torch.tensor(0.5)
        adamw_update(grads, opt, params, lr, decay=decay)
        want = before * (1 - 0.5 * 0.1) if decays else before
        assert decay[name] is decays
        torch.testing.assert_close(params[name].detach(), want, rtol=1e-6,
                                   atol=0)

    def test_decay_rule_equals_the_reference_on_a_restacked_tree(self):
        # the reference's p.ndim >= 2 on its own leaves, leaf for leaf
        cfg = smoke_config("rwkv6-7b")
        _, _, params = ref_setup("rwkv6-7b")
        model, _ = train_state_from_numpy(
            cfg, host((params, JA.adamw_init(params))), device="cpu")
        from repro_torch.convert import _reference_names
        ranks = {ref: jnp.ndim(leaf) for ref, leaf in
                 ((".".join(str(k.key) for k in path), leaf) for path, leaf
                  in jax.tree_util.tree_flatten_with_path(params)[0])}
        for name, p in model.named_parameters():
            ref, _ = _reference_names(model)[name]
            assert reference_leaf_rank(name, p.ndim) == ranks[ref], name

    def test_grad_clip_applies(self):
        params = {"w": torch.zeros(4)}
        opt = adamw_init(params)
        g = {"w": torch.full((4,), 1e6)}
        _, _, m = adamw_update(g, opt, params, torch.tensor(0.1),
                               AdamWConfig(grad_clip=1.0))
        assert float(m["grad_norm"]) > 1.0  # raw norm reported
        # the clipped first step is lr * sign(g), whatever its size
        torch.testing.assert_close(params["w"], torch.full((4,), -0.1))

    def test_clip_scale_matches_the_reference(self):
        g = np.random.default_rng(5).normal(size=(3, 7)).astype(np.float32)
        p = np.random.default_rng(6).normal(size=(3, 7)).astype(np.float32)
        for factor in (1e-3, 1.0, 1e4):
            jp = {"w": jnp.asarray(p)}
            wp, wo, _ = JA.adamw_update({"w": jnp.asarray(g * factor)},
                                        JA.adamw_init(jp), jp,
                                        jnp.float32(0.01))
            tp = {"w": torch.tensor(p)}
            _, to, _ = adamw_update({"w": torch.tensor(g * factor)},
                                    adamw_init(tp), tp, torch.tensor(0.01))
            for want, got in ((wp["w"], tp["w"]), (wo["m"]["w"], to["m"]["w"]),
                              (wo["v"]["w"], to["v"]["w"])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=0)

    def test_converges_on_quadratic(self):
        params = {"w": torch.tensor([5.0, -3.0], requires_grad=True)}
        opt = adamw_init(params)
        cfg = AdamWConfig(weight_decay=0.0)
        for _ in range(300):
            g, = torch.autograd.grad(torch.sum(params["w"] ** 2),
                                     [params["w"]])
            adamw_update({"w": g}, opt, params, torch.tensor(0.05), cfg)
        assert float(params["w"].detach().abs().max()) < 0.05

    def test_moments_are_float32_on_the_parameters_device(self):
        params = {"a": torch.zeros(2, 3, dtype=torch.bfloat16),
                  "b": torch.zeros(4)}
        opt = adamw_init(params)
        assert opt["count"].dtype == torch.int32 and opt["count"].shape == ()
        for key in ("m", "v"):
            assert all(t.dtype == torch.float32 and t.shape == params[n].shape
                       for n, t in opt[key].items())


# ---------------------------------------------------------------------------
# 3. data
# ---------------------------------------------------------------------------


class TestData:
    @pytest.mark.parametrize("frontend", [(0, 0), (3, 5)])
    @pytest.mark.parametrize("step,lo,hi", [(0, 0, None), (1, 0, 4),
                                            (7, 4, 8), (123, 3, 5)])
    def test_batches_equal_the_reference_byte_for_byte(self, step, lo, hi,
                                                       frontend):
        kw = dict(vocab=1000, seq_len=32, global_batch=8, seed=3,
                  frontend_tokens=frontend[0], frontend_dim=frontend[1])
        want = JSyntheticCorpus(JDataConfig(**kw)).batch(step, lo, hi)
        got = SyntheticCorpus(DataConfig(**kw)).batch(step, lo, hi)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            assert got[key].tobytes() == want[key].tobytes(), key

    def test_deterministic_and_shifted_labels(self):
        c = SyntheticCorpus(DataConfig(vocab=1000, seq_len=32,
                                       global_batch=8))
        b1, b2 = c.batch(5), c.batch(5)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
        np.testing.assert_array_equal(b1["tokens"][:, 1:],
                                      b1["labels"][:, :-1])
        assert not np.array_equal(b1["tokens"], c.batch(6)["tokens"])

    def test_host_sharding_partitions_global_batch(self):
        c = SyntheticCorpus(DataConfig(vocab=100, seq_len=8, global_batch=8))
        full = c.batch(3)
        np.testing.assert_array_equal(
            np.concatenate([c.batch(3, 0, 4)["tokens"],
                            c.batch(3, 4, 8)["tokens"]]), full["tokens"])

    def test_loader_prefetch(self):
        c = SyntheticCorpus(DataConfig(vocab=50, seq_len=4, global_batch=4))
        it = host_sharded_loader(c, host_id=1, n_hosts=2, start_step=7)
        step, batch = next(it)
        assert step == 7
        np.testing.assert_array_equal(batch["tokens"],
                                      c.batch(7, 2, 4)["tokens"])
        step, _ = next(it)
        assert step == 8

    def test_zipf_marginal(self):
        toks = SyntheticCorpus(DataConfig(vocab=1000, seq_len=256,
                                          global_batch=16)).batch(0)["tokens"]
        f0 = (toks == 0).mean()
        fmid = (toks == 500).mean()
        assert f0 > 10 * max(fmid, 1e-6)


# ---------------------------------------------------------------------------
# 4. the models' backward and one train step
# ---------------------------------------------------------------------------


class TestTrainStep:
    @pytest.mark.parametrize("dcim", (True, False), ids=("qat", "plain"))
    @pytest.mark.parametrize("arch", ARCHS)
    def test_one_step_matches_the_reference(self, arch, dcim, rec):
        # with fake-quant off no code can flip: every family's backward is
        # held at the tight tolerance there
        _, state0, batch, want, want_m = jax_step(arch, dcim_enabled=dcim)
        got, got_m = port_step(arch, state0, batch, dcim_enabled=dcim)
        flip = first_flip(rec) if dcim else None
        if dcim:
            assert_recomputed_alike(rec)
        else:
            assert not rec["port"] and not rec["jax"]
        assert_step_close(want, want_m, got, got_m, flip, arch)

    @pytest.mark.parametrize("arch", MICRO_ARCHS)
    def test_four_microbatches_match_the_reference(self, arch, rec):
        _, state0, batch, want, want_m = jax_step(arch, microbatches=4)
        got, got_m = port_step(arch, state0, batch, microbatches=4)
        assert_step_close(want, want_m, got, got_m, first_flip(rec),
                          f"{arch} x4 microbatches")

    @pytest.mark.parametrize("arch", ("llama3.2-3b", "granite-moe-1b-a400m",
                                      "whisper-tiny", "zamba2-1.2b"))
    def test_remat_gives_the_same_gradients_bit_for_bit(self, arch):
        # remat recomputes the blocks in the backward pass with the same
        # ops on the same inputs: the gradients are those without it
        grads = []
        for remat in (True, False):
            cfg = smoke_config(arch).replace(remat=remat)
            api = get_model(cfg)
            model = api.init_params(torch.Generator().manual_seed(SEED),
                                    device="cpu")
            batch = {k: torch.as_tensor(v) for k, v in
                     corpus_of(cfg, 4, 12).batch(0).items()}
            loss, _ = make_loss_fn(api)(model, batch)
            grads.append(torch.autograd.grad(loss, list(model.parameters())))
        for a, b in zip(*grads):
            assert torch.equal(a, b)

    def test_serving_paths_keep_no_graph(self):
        cfg = smoke_config("rwkv6-7b")
        api = get_model(cfg)
        model = api.init_params(device="cpu")
        tokens = torch.zeros((1, 4), dtype=torch.int64)
        logits, state = api.prefill(model, tokens, 8)
        assert not logits.requires_grad
        assert not any(t.requires_grad for t in state.values())

    @pytest.mark.parametrize("arch", ARCHS)
    def test_every_parameter_gets_a_finite_gradient(self, arch):
        cfg = smoke_config(arch)
        api = get_model(cfg)
        model = api.init_params(device="cpu")
        batch = {k: torch.as_tensor(v) for k, v in
                 corpus_of(cfg, 2, 12).batch(0).items()}
        loss, _ = make_loss_fn(api)(model, batch)
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(loss, list(model.parameters()),
                                    allow_unused=True)
        missing = [n for n, g in zip(names, grads) if g is None]
        assert not missing, missing
        sq = sum(float(torch.sum(g.double() ** 2)) for g in grads)
        assert np.isfinite(sq) and sq > 0.0
        assert all(torch.isfinite(g).all() for g in grads)

    def test_moe_aux_loss_reaches_the_router(self):
        # the reference's aux = e * sum(density * p_mean): gradient into the
        # router through the gates' mean, as jax.grad gives it (fake-quant
        # off: no code flip moves the routers' inputs)
        arch = "granite-moe-1b-a400m"
        cfg_j, api_j, params = ref_setup(arch, dcim_enabled=False)
        batch = corpus_of(cfg_j).batch(0)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        want = jax.jit(jax.grad(lambda p: api_j.forward_train(p, jb)[1]))(
            params)
        want = np.asarray(want["blocks"]["moe"]["router"])
        cfg = smoke_config(arch).replace(dcim_enabled=False)
        model, _ = train_state_from_numpy(
            cfg, host((params, JA.adamw_init(params))), device="cpu")
        _, aux = get_model(cfg).forward_train(
            model, {k: torch.as_tensor(v) for k, v in batch.items()})
        routers = [blk.moe.router for blk in model.blocks]
        got = torch.stack(torch.autograd.grad(aux, routers)).numpy()
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())

    def test_step_moves_a_numpy_batch_to_the_model_device(self):
        cfg = smoke_config("llama3.2-3b")
        api = get_model(cfg)
        model, opt = init_train_state(api, device="cpu")
        step = make_train_step(api, constant_lr(LR))
        batch = corpus_of(cfg, 2, 8).batch(0)
        assert isinstance(batch["tokens"], np.ndarray)
        model, opt, m = step(model, opt, batch)
        assert set(m) == {"loss", "ce", "aux", "grad_norm", "lr"}
        assert int(opt["count"]) == 1
        assert float(m["loss"]) == pytest.approx(
            float(m["ce"]) + AUX_COEF * float(m["aux"]))

    def test_train_state_needs_a_device_or_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is visible")
        with pytest.raises(RuntimeError, match='device="cpu"'):
            init_train_state(get_model(smoke_config("llama3.2-3b")))


# ---------------------------------------------------------------------------
# 5. the reference's training contracts (tests/test_training.py) on the port
# ---------------------------------------------------------------------------


def _port_setup(arch="llama3.2-3b", **replace):
    cfg = smoke_config(arch).replace(**replace)
    api = get_model(cfg)
    model, opt = init_train_state(api, torch.Generator().manual_seed(SEED),
                                  device="cpu")
    return cfg, api, model, opt


class TestTrainingContracts:
    def test_loss_decreases_under_dcim_qat(self):
        cfg, api, model, opt = _port_setup()
        corpus = corpus_of(cfg, 8, 32)
        step = make_train_step(api, constant_lr(3e-3))
        losses = []
        for i in range(12):
            model, opt, m = step(model, opt, corpus.batch(i))
            losses.append(float(m["loss"]))
        assert losses[-1] < losses[0] - 0.1, losses
        assert all(np.isfinite(losses))

    def test_microbatch_equals_full_batch_grads(self):
        cfg, api, model, opt = _port_setup()
        batch = corpus_of(cfg, 8, 16).batch(0)
        twin = get_model(cfg).init_params(device="cpu")
        twin.load_state_dict(model.state_dict())
        opt2 = adamw_init(dict(twin.named_parameters()))
        _, _, m1 = make_train_step(api, constant_lr(1e-3))(model, opt, batch)
        _, _, m2 = make_train_step(api, constant_lr(1e-3),
                                   microbatches=4)(twin, opt2, batch)
        assert abs(float(m1["loss"]) - float(m2["loss"])) < 2e-2
        d = max(float((a - b).abs().max()) for a, b in
                zip(model.parameters(), twin.parameters()))
        assert d < 5e-2

    def test_dcim_qat_vs_baseline_losses_comparable(self):
        def run(enabled):
            cfg, api, model, opt = _port_setup(dcim_enabled=enabled)
            corpus = corpus_of(cfg, 8, 32)
            step = make_train_step(api, constant_lr(3e-3))
            for i in range(10):
                model, opt, m = step(model, opt, corpus.batch(i))
            return float(m["loss"])

        qat, base = run(True), run(False)
        assert abs(qat - base) < 0.5, (qat, base)

    @pytest.mark.parametrize("arch", ("granite-moe-1b-a400m", "rwkv6-7b",
                                      "zamba2-1.2b", "whisper-tiny"))
    def test_loss_falls_in_each_family(self, arch):
        cfg, api, model, opt = _port_setup(arch)
        corpus = corpus_of(cfg, 4, 16)
        step = make_train_step(api, constant_lr(3e-3))
        losses = []
        for i in range(6):
            model, opt, m = step(model, opt, corpus.batch(i % 2))
            losses.append(float(m["loss"]))
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_step_config_is_the_reference_default():
    assert dataclasses.asdict(AdamWConfig()) == dataclasses.asdict(
        JA.AdamWConfig())
    import repro.train.step as JT
    assert AUX_COEF == JT.AUX_COEF
