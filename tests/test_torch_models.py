"""The torch port's model zoo (``repro_torch.quant``, ``models``,
``serve.step``) against the JAX package's, on the CPU.

The same numpy-seeded inputs go through the JAX function in process and
through its counterpart on ``device="cpu"``; the JAX package's own
initialised parameters are carried across by
``repro_torch.convert.model_params_from_numpy``.  ``repro.serve``'s package
init imports the engine (which needs the ``enable_x64`` shim), so the
reference's ``serve/step.py`` is loaded from its file alone.

Tolerances, and why:

* ``quantize_int`` / ``fake_quant`` / ``block_fp_align`` / ``fp8_e4m3_quant``
  — bit for bit (the same elementwise ops in the same dtype, scale computed
  in the input's dtype as the reference's weak-typed scalars make it).
* float32 layers and whole models — rtol/atol 1e-5: the two frameworks'
  matmuls sum in different orders, a few float32 ulps of values of order 1-5.
* With DCIM fake-quant on, a float32 difference of one ulp can move an
  activation across a rounding boundary of its int8 grid (a *flip*).  The
  tests record every int8 code both packages compute: where all codes agree
  the 1e-5 tolerance holds; where they do not, the first differing call must
  differ by one code step in at most 1% of its codes (a flip, not a
  different algorithm), the flips are printed, greedy tokens and argmax
  must still agree, and the values are held within 2% of the reference's
  largest magnitude (one int8 step is 0.8% of a row's range).
* bfloat16 (qwen3-4b smoke, DCIM off) — atol of four bfloat16 ulps at the
  logits' magnitude: the two frameworks round bf16 matmul outputs after
  differently ordered float32 sums, one ulp per rounding.
* MoE routing: the tests also record every expert choice both packages
  make.  Where they differ, the reference's gates of the two experts must
  tie within 1e-6 (a float32 near-tie, not another routing), and the flip
  tolerance above applies.  ``_top_k_dispatch`` itself: dispatch and
  combine bit for bit, the load-balance loss within 1e-6 relative (a mean
  summed in another order: two float32 ulps).
* ``chunked_gla`` / ``gla_decode_step`` / ``causal_conv1d`` — 1e-5 against
  the JAX functions, and the reference's own 2e-4 (5e-4 in the property
  test) against the sequential recurrence.
"""

import dataclasses
import importlib.util
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
import repro.models.moe as JMOE
import repro.quant.quantizers as JQ
from repro.models import cross_entropy_loss as jax_cross_entropy
from repro.models import get_model as jax_get_model
from repro.models import layers as JL
from repro.models import ssm as JSSM
from repro.parallel.logical import values_of

import repro_torch.configs as port_configs
import repro_torch.quant.quantizers as TQ
from repro_torch.convert import (decode_state_from_numpy,
                                 decode_state_to_numpy,
                                 model_params_from_numpy)
from repro_torch.models import cross_entropy_loss, get_model, model_class
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMOE
from repro_torch.models import ssm as TSSM
from repro_torch.models.transformer import Transformer
from repro_torch.quant import (QuantSpec, block_fp_align, dequantize,
                               fake_quant, fp8_e4m3_quant, quantize_int)
from repro_torch.serve import greedy_generate
from torch_expert_choices import expert_flip, record_expert_choices

REPO = pathlib.Path(__file__).resolve().parents[1]
SEED = 0
ARCHS = ("qwen3-4b", "llama3.2-3b", "phi3-mini-3.8b", "mistral-large-123b",
         "internvl2-1b", "whisper-tiny", "granite-moe-1b-a400m",
         "granite-moe-3b-a800m", "rwkv6-7b", "zamba2-1.2b")
RECURRENT = ("rwkv6-7b", "zamba2-1.2b")
EXPERT_TIE = 1e-6       # reference gates within this count as a near-tie
F32_TOL = dict(rtol=1e-5, atol=1e-5)
FLIP_FRAC = 0.02        # flip tolerance: share of the reference's max |value|
FLIP_CODES = 0.01       # at most this share of the first differing call's codes
B, S, PROMPT, DECODE = 2, 24, 16, 4


def _load_jax_step():
    spec = importlib.util.spec_from_file_location(
        "repro.serve.step", REPO / "src" / "repro" / "serve" / "step.py")
    mod = importlib.util.module_from_spec(spec)
    mod.__package__ = "repro.serve"
    spec.loader.exec_module(mod)
    return mod


jax_step = _load_jax_step()


def t(x) -> torch.Tensor:
    """A numpy (or JAX) array as a CPU tensor."""
    x = np.array(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def n(x) -> np.ndarray:
    """A tensor or JAX array as float64 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32), dtype=np.float64)


def _bits(x) -> np.ndarray:
    """The bit patterns of a float tensor or JAX array, for bitwise
    equality."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().view(np.int32 if x.dtype == torch.float32
                              else np.int8)
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.view(np.int16)
    return x.view(np.int32 if x.dtype == np.float32 else np.int8)


# ---------------------------------------------------------------------------
# int8 codes of both packages (flip accounting)
# ---------------------------------------------------------------------------


@pytest.fixture
def codes(monkeypatch):
    """Record every ``quantize_int`` code array both packages compute, in
    call order (JAX through an ordered debug callback: its calls run under
    ``lax.scan`` traces), and every MoE dispatch's expert choices with the
    gates they came from (``experts``)."""
    port_experts = record_expert_choices(monkeypatch)
    rec = {"jax": [], "port": [],
           "experts": {"jax": [], "port": port_experts["cpu"]}}
    jax_q, port_q = JQ.quantize_int, TQ.quantize_int
    jax_d = JMOE._top_k_dispatch

    def jax_dispatch(gates, k, capacity):
        jax.debug.callback(
            lambda g, i: rec["experts"]["jax"].append(
                (np.asarray(g), np.asarray(i))),
            gates, jax.lax.top_k(gates, k)[1], ordered=True)
        return jax_d(gates, k, capacity)

    def jax_rec(*a, **k):
        q, s = jax_q(*a, **k)
        jax.debug.callback(lambda v: rec["jax"].append(np.asarray(v)), q,
                           ordered=True)
        return q, s

    def port_rec(*a, **k):
        q, s = port_q(*a, **k)
        rec["port"].append(q.numpy().copy())
        return q, s

    monkeypatch.setattr(JQ, "quantize_int", jax_rec)
    monkeypatch.setattr(TQ, "quantize_int", port_rec)
    monkeypatch.setattr(JMOE, "_top_k_dispatch", jax_dispatch)
    return rec


def first_flip(rec) -> tuple[int, int, int] | None:
    """(call index, flipped codes, codes in the call) of the first
    fake-quant call whose codes differ, or None.  Every earlier call agrees
    bit for bit; the first differing one may differ only by one code step
    in at most ``FLIP_CODES`` of its codes.  Failing that, the same of the
    first MoE dispatch whose expert choices differ, each a near-tie of the
    reference's gates within ``EXPERT_TIE`` (:func:`expert_flip`)."""
    jax.effects_barrier()
    got, want = rec["port"], rec["jax"]
    assert len(got) == len(want), (len(got), len(want))
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (i, a.shape, b.shape)
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        if d.any():
            flips = int((d > 0).sum())
            assert d.max() == 1, f"call {i}: codes differ by {d.max()}"
            assert flips <= FLIP_CODES * d.size, (i, flips, d.size)
            return i, flips, d.size
    return expert_flip(rec["experts"]["port"], rec["experts"]["jax"],
                       EXPERT_TIE)


def assert_close_or_flipped(got, want, flip, what: str) -> None:
    """The 1e-5 tolerance without a flip; with one, FLIP_FRAC of the
    reference's largest magnitude (module doc), and the flip printed."""
    got, want = n(got), n(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if flip is None:
        np.testing.assert_allclose(got, want, err_msg=what, **F32_TOL)
        return
    call, flips, size = flip
    print(f"{what}: fake-quant or expert flip at call {call}: {flips} of "
          f"{size}; max |diff| {np.abs(got - want).max():.6g}")
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FLIP_FRAC * np.abs(want).max(),
                               err_msg=what)


# ---------------------------------------------------------------------------
# 1. quant
# ---------------------------------------------------------------------------

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def quant_input(dtype: str, shape=(48, 80)):
    rng = np.random.default_rng(SEED)
    x = (rng.normal(size=shape) * rng.lognormal(size=(shape[0], 1)))
    jx = jnp.asarray(x, jnp.float32).astype(DTYPES[dtype][0])
    return jx, t(jx)


class TestQuant:
    @pytest.mark.parametrize("bits", (4, 8))
    @pytest.mark.parametrize("axis", (-1, 0, None))
    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_quantize_int_bitwise(self, dtype, axis, bits):
        jx, tx = quant_input(dtype)
        jq, js = JQ.quantize_int(jx, bits, axis)
        tq, ts = quantize_int(tx, bits, axis)
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(_bits(ts), _bits(js))

    @pytest.mark.parametrize("bits", (4, 8))
    @pytest.mark.parametrize("axis", (-1, 0, None))
    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_fake_quant_bitwise(self, dtype, axis, bits):
        jx, tx = quant_input(dtype)
        got, want = fake_quant(tx, bits, axis), JQ.fake_quant(jx, bits, axis)
        assert got.dtype == tx.dtype
        np.testing.assert_array_equal(_bits(got), _bits(want))

    def test_bf16_scale_is_computed_in_bf16(self):
        # the scale max(amax, eps) / qmax is a bfloat16 value before the
        # float32 cast: computing it in float32 would give another scale
        _, tx = quant_input("bfloat16")
        _, s = quantize_int(tx, 8, -1)
        assert torch.equal(s, s.to(torch.bfloat16).to(torch.float32))
        amax = tx.float().abs().amax(-1, keepdim=True)
        assert not torch.equal(s, amax / 127)

    def test_dequantize(self):
        jx, tx = quant_input("float32")
        jq, js = JQ.quantize_int(jx, 8, -1)
        got = dequantize(t(jq), t(js))
        np.testing.assert_array_equal(_bits(got),
                                      _bits(JQ.dequantize(jq, js)))

    @pytest.mark.parametrize("man_bits", (3, 7))
    def test_block_fp_align_bitwise(self, man_bits):
        jx, tx = quant_input("float32")
        jm, js = JQ.block_fp_align(jx, man_bits)
        tm, ts = block_fp_align(tx, man_bits)
        assert tm.dtype == torch.int32
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(_bits(ts), _bits(js))

    def test_fp8_e4m3_bitwise(self):
        jx, tx = quant_input("float32")
        jx, tx = jx * 100, tx * 100       # past the 448 saturation too
        np.testing.assert_array_equal(_bits(fp8_e4m3_quant(tx)),
                                      _bits(JQ.fp8_e4m3_quant(jx)))

    def test_fake_quant_straight_through(self):
        _, tx = quant_input("float32")
        x = tx.clone().requires_grad_(True)
        (fake_quant(x, 8, -1) * 3.0).sum().backward()
        assert torch.equal(x.grad, torch.full_like(tx, 3.0))

    def test_quantspec(self):
        assert QuantSpec() == QuantSpec(8, 8, "int")
        for bad in ({"a_bits": 3}, {"w_bits": 5}, {"mode": "fp4"}):
            with pytest.raises(ValueError):
                QuantSpec(**bad)


# ---------------------------------------------------------------------------
# 2. layers
# ---------------------------------------------------------------------------


def normal(*shape, seed=SEED, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


class TestLayers:
    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_rmsnorm(self, dtype):
        x, g = normal(3, 7, 64), normal(64, seed=1)
        jx = jnp.asarray(x).astype(DTYPES[dtype][0])
        want = JL.rmsnorm_apply({"g": jnp.asarray(g)}, jx)
        got = TL.rmsnorm_apply(t(g), t(jx))
        assert got.dtype == DTYPES[dtype][1]
        np.testing.assert_allclose(n(got), n(want), **F32_TOL)

    @pytest.mark.parametrize("offset", (0, 37))
    def test_rope(self, offset):
        x = normal(2, 9, 4, 16)
        pos = np.broadcast_to(offset + np.arange(9), (2, 9))
        want = JL.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
        got = TL.rope(t(x), t(pos), 1e6)
        np.testing.assert_allclose(n(got), n(want), **F32_TOL)

    @pytest.mark.parametrize("causal", (True, False))
    @pytest.mark.parametrize("case", (
        # (Sq, Skv, Hq, Hkv, q_block, kv_block, q_offset)
        (32, 32, 4, 4, 32, 64, 0),        # one block each
        (64, 64, 4, 2, 16, 16, 0),        # GQA, many whole blocks
        (40, 40, 4, 2, 16, 8, 0),         # ragged query block
        (8, 40, 4, 1, 4, 8, 32),          # query offset (chunked prefill)
    ), ids=("one_block", "gqa_blocks", "ragged_q", "q_offset"))
    def test_blockwise_attention(self, causal, case):
        sq, skv, hq, hkv, qb, kvb, off = case
        q, k, v = (normal(2, s, h, 16, seed=i) for i, (s, h) in
                   enumerate(((sq, hq), (skv, hkv), (skv, hkv))))
        kw = dict(causal=causal, q_block=qb, kv_block=kvb, q_offset=off)
        want = JL.blockwise_attention(*map(jnp.asarray, (q, k, v)), **kw)
        got = TL.blockwise_attention(t(q), t(k), t(v), **kw)
        np.testing.assert_allclose(n(got), n(want), **F32_TOL)

    @pytest.mark.parametrize("causal", (True, False))
    def test_blockwise_attention_ragged_kv_follows_reference(self, causal):
        # Skv = 100 with 64-key blocks: the reference's dynamic_slice clamps
        # the last block's start to 36 while its mask keeps positions
        # 64..127, so that block attends keys 36..71 (ROADMAP.md,
        # "Reference state").  The port reproduces it; both differ from
        # exact attention.
        q, k, v = (normal(1, 100, 2, 8, seed=i) for i in range(3))
        kw = dict(causal=causal, q_block=32, kv_block=64)
        want = JL.blockwise_attention(*map(jnp.asarray, (q, k, v)), **kw)
        got = TL.blockwise_attention(t(q), t(k), t(v), **kw)
        np.testing.assert_allclose(n(got), n(want), **F32_TOL)
        exact = TL.blockwise_attention(t(q), t(k), t(v), causal=causal,
                                       q_block=32, kv_block=100)
        assert np.abs(n(got) - n(exact)).max() > 0.1

    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_mask_padded_vocab(self, dtype):
        x = jnp.asarray(normal(2, 3, 12)).astype(DTYPES[dtype][0])
        want = JL.mask_padded_vocab(x, 10)
        got = TL.mask_padded_vocab(t(x), 10)
        np.testing.assert_array_equal(_bits(got), _bits(want))
        if dtype == "bfloat16":
            assert torch.isneginf(got[..., 10:]).all()

    @pytest.mark.parametrize("enabled", (True, False))
    def test_dcim_linear(self, enabled):
        w, x = normal(64, 48, scale=0.125), normal(2, 5, 64, seed=1)
        want = JL.dcim_linear_apply(jnp.asarray(w), jnp.asarray(x),
                                    enabled=enabled,
                                    compute_dtype=jnp.float32)
        got = TL.dcim_linear_apply(t(w), t(x), enabled=enabled,
                                   compute_dtype=torch.float32)
        np.testing.assert_allclose(n(got), n(want), **F32_TOL)

    def test_init_param_law(self):
        g = torch.Generator().manual_seed(SEED)
        w = torch.empty(512, 256, dtype=torch.bfloat16)
        TL.init_param(w, g)
        assert w.dtype == torch.bfloat16
        assert abs(w.float().std().item() * 512 ** 0.5 - 1) < 0.02
        TL.init_param(w, g, scale=0.5)
        assert abs(w.float().std().item() / 0.5 - 1) < 0.02
        a, b = torch.empty(64, 8), torch.empty(64, 8)
        TL.init_param(a, torch.Generator().manual_seed(3))
        TL.init_param(b, torch.Generator().manual_seed(3))
        assert torch.equal(a, b)


def attention_case(arch: str):
    cfg = jax_configs.smoke_config(arch)
    p = values_of(JL.attention_init(jax.random.PRNGKey(SEED), cfg,
                                    jnp.float32))
    port = TL.Attention(port_configs.smoke_config(arch), torch.float32,
                        "cpu")
    for name, mod in port.named_children():
        leaf = p[name]["g"] if name.endswith("norm") else p[name]
        with torch.no_grad():
            (mod.g if name.endswith("norm") else mod.w).copy_(t(leaf))
    return cfg, p, port


class TestAttention:
    @pytest.mark.parametrize("arch", ("qwen3-4b", "llama3.2-3b"))
    def test_plain(self, arch, codes):
        cfg, p, port = attention_case(arch)
        x = normal(B, 20, cfg.d_model)
        pos = np.broadcast_to(np.arange(20), (B, 20))
        want, _ = JL.attention_apply(p, jnp.asarray(x), cfg,
                                     positions=jnp.asarray(pos))
        got = port(t(x), positions=t(pos))
        assert_close_or_flipped(got, want, first_flip(codes), arch)

    @pytest.mark.parametrize("arch", ("qwen3-4b", "llama3.2-3b"))
    def test_prefill_then_decode(self, arch, codes):
        cfg, p, port = attention_case(arch)
        x = normal(B, 13, cfg.d_model)
        shape = (B, 16, cfg.n_kv_heads, cfg.hd)
        jcache = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
        tcache = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
        pos = np.broadcast_to(np.arange(12), (B, 12))
        want, jcache = JL.attention_apply(
            p, jnp.asarray(x[:, :12]), cfg, positions=jnp.asarray(pos),
            kv_cache=jcache, cache_pos=jnp.int32(0), prefill_fill=True)
        got = port(t(x[:, :12]), positions=t(pos), kv_cache=tcache,
                   cache_pos=torch.tensor(0, dtype=torch.int32),
                   prefill_fill=True)
        flip = first_flip(codes)
        assert_close_or_flipped(got, want, flip, f"{arch} prefill")
        for key in ("k", "v"):
            assert_close_or_flipped(tcache[key], jcache[key], flip,
                                    f"{arch} prefill cache {key}")
        pos = np.full((B, 1), 12)
        want, jcache = JL.attention_apply(
            p, jnp.asarray(x[:, 12:]), cfg, positions=jnp.asarray(pos),
            kv_cache=jcache, cache_pos=jnp.int32(12))
        got = port(t(x[:, 12:]), positions=t(pos), kv_cache=tcache,
                   cache_pos=torch.tensor(12, dtype=torch.int32))
        flip = first_flip(codes)
        assert_close_or_flipped(got, want, flip, f"{arch} decode")
        for key in ("k", "v"):
            assert_close_or_flipped(tcache[key], jcache[key], flip,
                                    f"{arch} decode cache {key}")
        # the decode wrote position 12 and nothing past it
        assert torch.count_nonzero(tcache["k"][:, 13:]) == 0

    def test_decode_past_the_cache_clamps_like_the_reference(self):
        cfg, p, port = attention_case("llama3.2-3b")
        x = normal(B, 1, cfg.d_model)
        shape = (B, 4, cfg.n_kv_heads, cfg.hd)
        caches = normal(2, *shape, seed=5)
        jcache = {"k": jnp.asarray(caches[0]), "v": jnp.asarray(caches[1])}
        tcache = {"k": t(caches[0]).clone(), "v": t(caches[1]).clone()}
        pos = np.full((B, 1), 6)
        JL.attention_apply(p, jnp.asarray(x), cfg,
                           positions=jnp.asarray(pos), kv_cache=jcache,
                           cache_pos=jnp.int32(6))
        _, jcache = JL.attention_apply(p, jnp.asarray(x), cfg,
                                       positions=jnp.asarray(pos),
                                       kv_cache=jcache,
                                       cache_pos=jnp.int32(6))
        port(t(x), positions=t(pos), kv_cache=tcache,
             cache_pos=torch.tensor(6, dtype=torch.int32))
        for key in ("k", "v"):
            np.testing.assert_allclose(n(tcache[key]), n(jcache[key]),
                                       **F32_TOL)


# ---------------------------------------------------------------------------
# 2b. the recurrences (models/ssm.py) and MoE dispatch (models/moe.py)
# ---------------------------------------------------------------------------


def gla_inputs(t, *, seed=42, b=2, h=3, dk=8, dv=8, decay=(0.01, 0.5),
               use_u=True):
    """q, k, v, log_w (and u) as numpy from default_rng(seed), the
    reference's test inputs (``tests/test_ssm_gla.py``)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, t, h, dk)).astype(np.float32)
    k = rng.normal(size=(b, t, h, dk)).astype(np.float32)
    v = rng.normal(size=(b, t, h, dv)).astype(np.float32)
    lw = (-rng.uniform(*decay, size=(b, t, h, dk))).astype(np.float32)
    u = rng.normal(size=(h, dk)).astype(np.float32) if use_u else None
    return q, k, v, lw, u


def seq_ref(q, k, v, lw, u, inclusive):
    """The sequential recurrence through the port's gla_decode_step."""
    b, t, h, dk = q.shape
    s = torch.zeros((b, h, dk, v.shape[-1]))
    ys = []
    for i in range(t):
        y, s = TSSM.gla_decode_step(q[:, i], k[:, i], v[:, i], lw[:, i], s,
                                    u=u, inclusive=inclusive)
        ys.append(y)
    return torch.stack(ys, 1), s


def jt(*xs):
    """numpy arrays (or None) as (JAX arrays, CPU tensors)."""
    return ([None if x is None else jnp.asarray(x) for x in xs],
            [None if x is None else t(x) for x in xs])


class TestSsm:
    @pytest.mark.parametrize("inclusive,use_u", [(True, False), (False, True),
                                                 (False, False)])
    @pytest.mark.parametrize("steps,chunk", [(16, 16), (37, 16), (64, 8),
                                             (5, 32)])
    def test_chunked_gla(self, inclusive, use_u, steps, chunk):
        q, k, v, lw, u = gla_inputs(steps, use_u=use_u)
        (jq, jk, jv, jlw, ju), (tq, tk, tv, tlw, tu) = jt(q, k, v, lw, u)
        yw, sw = JSSM.chunked_gla(jq, jk, jv, jlw, u=ju, inclusive=inclusive,
                                  chunk=chunk)
        yg, sg = TSSM.chunked_gla(tq, tk, tv, tlw, u=tu, inclusive=inclusive,
                                  chunk=chunk)
        assert yg.dtype == sg.dtype == torch.float32
        np.testing.assert_allclose(n(yg), n(yw), **F32_TOL)
        np.testing.assert_allclose(n(sg), n(sw), **F32_TOL)
        # the reference's own check: chunked == sequential within 2e-4
        ys, ss = seq_ref(tq, tk, tv, tlw, tu, inclusive)
        np.testing.assert_allclose(n(yg), n(ys), atol=2e-4)
        np.testing.assert_allclose(n(sg), n(ss), atol=2e-4)

    @pytest.mark.parametrize("seed", range(6))
    def test_chunked_gla_property(self, seed):
        # the reference's property test, at numpy-drawn examples
        rng = np.random.default_rng(seed)
        steps, chunk = int(rng.integers(1, 49)), int(rng.choice([4, 8, 16]))
        q, k, v, lw, _ = gla_inputs(steps, seed=seed, b=1, h=2, dk=4, dv=4,
                                    decay=(0.0, float(rng.uniform(0, 2))),
                                    use_u=False)
        (jq, jk, jv, jlw), (tq, tk, tv, tlw) = jt(q, k, v, lw)
        yg, _ = TSSM.chunked_gla(tq, tk, tv, tlw, inclusive=True,
                                 chunk=chunk)
        yw, _ = JSSM.chunked_gla(jq, jk, jv, jlw, inclusive=True, chunk=chunk)
        np.testing.assert_allclose(n(yg), n(yw), **F32_TOL)
        ys, _ = seq_ref(tq, tk, tv, tlw, None, True)
        np.testing.assert_allclose(n(yg), n(ys), atol=5e-4)

    @pytest.mark.parametrize("inclusive", (True, False))
    def test_decode_step(self, inclusive):
        q, k, v, lw, u = gla_inputs(1, seed=7)
        s0 = normal(2, 3, 8, 8, seed=8)
        (jq, jk, jv, jlw, ju, js), (tq, tk, tv, tlw, tu, ts) = jt(
            q[:, 0], k[:, 0], v[:, 0], lw[:, 0], u, s0)
        yw, sw = JSSM.gla_decode_step(jq, jk, jv, jlw, js, u=ju,
                                      inclusive=inclusive)
        yg, sg = TSSM.gla_decode_step(tq, tk, tv, tlw, ts, u=tu,
                                      inclusive=inclusive)
        np.testing.assert_allclose(n(yg), n(yw), **F32_TOL)
        np.testing.assert_allclose(n(sg), n(sw), **F32_TOL)

    def test_state_continuation(self):
        """Splitting a sequence across two chunked_gla calls with the state
        handed over (s0) equals one pass, and the JAX package's."""
        q, k, v, lw, _ = gla_inputs(32, seed=3, b=1, h=2, dk=4, dv=4,
                                    decay=(0.01, 0.3), use_u=False)
        (jq, jk, jv, jlw), (tq, tk, tv, tlw) = jt(q, k, v, lw)
        y_full, s_full = TSSM.chunked_gla(tq, tk, tv, tlw, inclusive=True,
                                          chunk=8)
        y1, s1 = TSSM.chunked_gla(tq[:, :16], tk[:, :16], tv[:, :16],
                                  tlw[:, :16], inclusive=True, chunk=8)
        y2, s2 = TSSM.chunked_gla(tq[:, 16:], tk[:, 16:], tv[:, 16:],
                                  tlw[:, 16:], inclusive=True, chunk=8, s0=s1)
        np.testing.assert_allclose(n(torch.cat([y1, y2], 1)), n(y_full),
                                   atol=2e-4)
        np.testing.assert_allclose(n(s2), n(s_full), atol=2e-4)
        _, js1 = JSSM.chunked_gla(jq[:, :16], jk[:, :16], jv[:, :16],
                                  jlw[:, :16], inclusive=True, chunk=8)
        jy2, js2 = JSSM.chunked_gla(jq[:, 16:], jk[:, 16:], jv[:, 16:],
                                    jlw[:, 16:], inclusive=True, chunk=8,
                                    s0=js1)
        np.testing.assert_allclose(n(y2), n(jy2), **F32_TOL)
        np.testing.assert_allclose(n(s2), n(js2), **F32_TOL)

    def test_causal_conv1d(self):
        x, w = normal(2, 12, 6), normal(4, 6, seed=1)
        y_full, cache = TSSM.causal_conv1d(t(x), t(w))
        jy, jcache = JSSM.causal_conv1d(jnp.asarray(x), jnp.asarray(w))
        np.testing.assert_allclose(n(y_full), n(jy), **F32_TOL)
        np.testing.assert_allclose(n(cache), n(jcache), **F32_TOL)
        # decode token by token through the cache == the whole sequence
        cache, jcache, ys = None, None, []
        for i in range(12):
            y, cache = TSSM.causal_conv1d(t(x[:, i:i + 1]), t(w), cache)
            jy, jcache = JSSM.causal_conv1d(jnp.asarray(x[:, i:i + 1]),
                                            jnp.asarray(w), jcache)
            np.testing.assert_allclose(n(y), n(jy), **F32_TOL)
            ys.append(y)
        np.testing.assert_allclose(n(torch.cat(ys, 1)), n(y_full), atol=1e-5)
        np.testing.assert_allclose(n(cache), n(jcache), **F32_TOL)

    def test_rwkv6_chunk_overflows_like_the_reference(self):
        # exp(-cumsum(log_w)) over one chunk at RWKV6's initial decay
        # (log w = -exp(-1)): from token 239 on the chunk's factors leave
        # float32 and both packages turn non-finite at the same positions
        # (ROADMAP.md, "Reference state"); 64 and 200 tokens stay finite
        # and agree.  At 232 tokens both are finite but q * exp(ccum)
        # reaches float32's denormals, which XLA on the CPU flushes to
        # zero and torch keeps: the packages differ by 3e-3 of the largest
        # value, the port stays on the sequential recurrence, and with
        # denormals flushed in torch too the two agree within 1e-5.
        for steps in (64, 200, 232, 240, 248, 256):
            rng = np.random.default_rng(0)
            q, k, v = (rng.normal(size=(1, steps, 2, 64)).astype(np.float32)
                       for _ in range(3))
            lw = np.full((1, steps, 2, 64), -np.exp(-1.0), np.float32)
            u = np.full((2, 64), 0.5, np.float32)
            (jq, jk, jv, jlw, ju), (tq, tk, tv, tlw, tu) = jt(q, k, v, lw, u)
            yw, _ = JSSM.chunked_gla(jq, jk, jv, jlw, u=ju, chunk=256)
            yg, _ = TSSM.chunked_gla(tq, tk, tv, tlw, u=tu, chunk=256)
            bad_w, bad_g = ~np.isfinite(n(yw)), ~np.isfinite(n(yg))
            np.testing.assert_array_equal(bad_g, bad_w, err_msg=str(steps))
            scale = np.abs(n(yw)).max()
            if steps <= 200:
                assert not bad_g.any()
                np.testing.assert_allclose(n(yg), n(yw), rtol=0,
                                           atol=1e-5 * scale)
            elif steps == 232:
                assert not bad_g.any()
                gap = np.abs(n(yg) - n(yw)).max() / scale
                assert 2e-3 < gap < 4e-3, gap
                want, _ = seq_ref(tq, tk, tv, tlw, tu, False)
                np.testing.assert_allclose(n(yg), n(want), rtol=2e-4,
                                           atol=2e-4)
                assert torch.set_flush_denormal(True)
                try:
                    flushed, _ = TSSM.chunked_gla(tq, tk, tv, tlw, u=tu,
                                                  chunk=256)
                finally:
                    torch.set_flush_denormal(False)
                np.testing.assert_allclose(n(flushed), n(yw), rtol=0,
                                           atol=1e-5 * scale)
            else:
                assert np.isnan(n(yw)).any()
                first = np.argwhere(bad_g.any(axis=(0, 2, 3))).min()
                assert first == 239, steps


class TestMoeDispatch:
    @pytest.mark.parametrize("g,s,e,k,cap", [
        (2, 64, 8, 2, 20),        # room for every choice
        (1, 48, 4, 2, 8),         # overflow drops (cap < S·k/E)
        (3, 4, 40, 8, 1),         # granite-3b's decode: 4 tokens, cap 1
        (1, 256, 40, 8, 64),      # granite-3b's prefill group
    ])
    def test_top_k_dispatch(self, g, s, e, k, cap):
        logits = normal(g, s, e, scale=2.0)
        gates = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
        jd, jc, jaux = JMOE._top_k_dispatch(jnp.asarray(gates), k, cap)
        td, tc, taux = TMOE._top_k_dispatch(t(gates), k, cap)
        assert td.dtype == torch.bool and tc.dtype == torch.float32
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(_bits(tc), _bits(jc))
        np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-6)

    def test_top_k_ties_take_the_lower_expert(self):
        gates = np.array([[[0.1, 0.3, 0.3, 0.2, 0.3, 0.3]]], np.float32)
        _, ji = jax.lax.top_k(jnp.asarray(gates), 3)
        tv, ti = TMOE._top_k(t(gates), 3)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert ti.tolist() == [[[1, 2, 4]]]
        jd, jc, _ = JMOE._top_k_dispatch(jnp.asarray(gates), 3, 1)
        td, tc, _ = TMOE._top_k_dispatch(t(gates), 3, 1)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(_bits(tc), _bits(jc))

    def test_expert_fake_quant_is_per_expert_and_column(self):
        # fake_quant(w, bits, 1) on (E, d, ff): one scale per expert and
        # output column, bit for bit with the reference
        w = normal(4, 16, 8, scale=0.3) * np.arange(1, 5)[:, None, None]
        got = fake_quant(t(w.astype(np.float32)), 8, 1)
        want = JQ.fake_quant(jnp.asarray(w, jnp.float32), 8, 1)
        np.testing.assert_array_equal(_bits(got), _bits(want))
        _, scale = quantize_int(t(w.astype(np.float32)), 8, 1)
        assert scale.shape == (4, 1, 8)

    def test_group_must_divide_the_tokens_like_the_reference(self):
        # 4 x 65 = 260 tokens: more than one 256-token group and not a
        # multiple of it; the reference's reshape raises TypeError
        # (ROADMAP.md, "Reference state"), and so does the port
        jcfg, japi, params, _, api, model = zoo("granite-moe-1b-a400m")
        tokens = np.random.default_rng(SEED).integers(0, jcfg.vocab, (4, 65))
        with pytest.raises(TypeError, match="cannot reshape"):
            japi.prefill(params, jnp.asarray(tokens), 65)
        with pytest.raises(TypeError, match="cannot reshape"):
            api.prefill(model, t(tokens), 65)
        for rows in (4, 8):           # 256 and 512 tokens are whole groups
            x = t(normal(rows, 64, jcfg.d_model))
            y, _ = model.blocks[0].moe(x)
            assert y.shape == x.shape


# ---------------------------------------------------------------------------
# 3. whole models
# ---------------------------------------------------------------------------

_ZOO: dict = {}


def zoo(arch: str, **replace):
    """(JAX cfg, JAX api, JAX params, port cfg, port api, port model) of a
    smoke config with ``replace`` applied, the JAX params drawn from
    PRNGKey(SEED) and carried across; built once per key."""
    key = (arch, tuple(sorted(replace.items())))
    if key not in _ZOO:
        jcfg = jax_configs.smoke_config(arch).replace(**replace)
        pcfg = port_configs.smoke_config(arch).replace(**replace)
        japi = jax_get_model(jcfg)
        params = values_of(japi.init_params(jax.random.PRNGKey(SEED)))
        model = model_params_from_numpy(
            pcfg, jax.tree.map(np.asarray, params), device="cpu")
        _ZOO[key] = (jcfg, japi, params, pcfg, get_model(pcfg), model)
    return _ZOO[key]


def batch_of(cfg, s: int = S):
    """Tokens (and frontend embeddings) from default_rng(SEED): the JAX
    batch and the port's."""
    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, cfg.vocab, (B, s))
    jb, pb = {"tokens": jnp.asarray(tokens)}, {"tokens": t(tokens)}
    if cfg.frontend is not None:
        f = normal(B, cfg.frontend.n_tokens, cfg.frontend.d_frontend,
                   seed=SEED + 1)
        jb["frontend"], pb["frontend"] = jnp.asarray(f), t(f)
    return jb, pb


class TestModels:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_forward_dcim_off(self, arch):
        jcfg, japi, params, _, api, model = zoo(arch, dcim_enabled=False)
        jb, pb = batch_of(jcfg)
        want, jaux = japi.forward_train(params, jb)
        got, aux = api.forward_train(model, pb)
        assert got.shape == (B, S, jcfg.vocab_padded)
        np.testing.assert_allclose(n(got), n(want), **F32_TOL)
        if jcfg.family == "moe":
            # the blocks' mean load-balance loss
            assert aux.item() > 0
            np.testing.assert_allclose(aux.item(), float(jaux), **F32_TOL)
        else:
            assert aux.item() == float(jaux) == 0.0

    @pytest.mark.parametrize("arch", ARCHS)
    def test_forward_dcim_on(self, arch, codes):
        jcfg, japi, params, _, api, model = zoo(arch)
        assert jcfg.dcim_enabled
        jb, pb = batch_of(jcfg)
        want, _ = japi.forward_train(params, jb)
        got, _ = api.forward_train(model, pb)
        assert_close_or_flipped(got, want, first_flip(codes), arch)
        np.testing.assert_array_equal(n(got).argmax(-1), n(want).argmax(-1))

    @pytest.mark.parametrize("arch", ARCHS)
    def test_prefill_and_decode_caches(self, arch, codes):
        jcfg, japi, params, pcfg, api, model = zoo(arch)
        jb, pb = batch_of(jcfg)
        cache_len = PROMPT + DECODE + 2
        jl, js = japi.prefill(params, jb["tokens"][:, :PROMPT], cache_len,
                              frontend=jb.get("frontend"))
        pl, ps = api.prefill(model, pb["tokens"][:, :PROMPT], cache_len,
                             frontend=pb.get("frontend"))
        for step in range(PROMPT, PROMPT + DECODE):
            jl, js = japi.decode_step(params, js,
                                      jb["tokens"][:, step:step + 1])
            pl, ps = api.decode_step(model, ps,
                                     pb["tokens"][:, step:step + 1])
        flip = first_flip(codes)
        assert_close_or_flipped(pl, jl, flip, f"{arch} decode logits")
        got = decode_state_to_numpy(ps)
        assert sorted(got) == sorted(js)
        assert int(got["pos"]) == int(js["pos"]) == PROMPT + DECODE
        assert got["pos"].dtype == np.int32
        for key in set(got) - {"pos"}:
            assert got[key].shape == js[key].shape
            assert_close_or_flipped(got[key], js[key], flip,
                                    f"{arch} state {key}")

    @pytest.mark.parametrize("arch", ARCHS)
    def test_greedy_generate(self, arch):
        jcfg, japi, params, _, api, model = zoo(arch)
        jb, pb = batch_of(jcfg)
        want = jax_step.greedy_generate(japi, params, jb["tokens"][:, :8], 6,
                                        frontend=jb.get("frontend"))
        got = greedy_generate(api, model, pb["tokens"][:, :8], 6,
                              frontend=pb.get("frontend"))
        assert got.shape == (B, 6)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_forward_bf16(self):
        jcfg, japi, params, _, api, model = zoo(
            "qwen3-4b", dcim_enabled=False, param_dtype="bfloat16",
            compute_dtype="bfloat16")
        jb, pb = batch_of(jcfg)
        want, _ = japi.forward_train(params, jb)
        got, _ = api.forward_train(model, pb)
        assert got.dtype == torch.bfloat16
        want = n(want)
        ulp = 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(n(got), want, rtol=0, atol=4 * ulp)

    @pytest.mark.parametrize("arch", RECURRENT)
    def test_recurrent_decode_bf16(self, arch):
        # bf16 params and compute, DCIM off: prefill and decode steps with
        # the state cast as the reference casts it (shift_t, conv), the
        # logits within 8 bfloat16 ulps at their magnitude (two ulps per
        # rounding of differently ordered sums, over prefill and decode)
        jcfg, japi, params, _, api, model = zoo(
            arch, dcim_enabled=False, param_dtype="bfloat16",
            compute_dtype="bfloat16")
        jb, pb = batch_of(jcfg)
        jl, js = japi.prefill(params, jb["tokens"][:, :PROMPT], S)
        pl, ps = api.prefill(model, pb["tokens"][:, :PROMPT], S)
        for step in range(PROMPT, PROMPT + DECODE):
            jl, js = japi.decode_step(params, js,
                                      jb["tokens"][:, step:step + 1])
            pl, ps = api.decode_step(model, ps,
                                     pb["tokens"][:, step:step + 1])
        assert pl.dtype == torch.bfloat16
        for key, x in ps.items():
            assert str(x.dtype).removeprefix("torch.") == \
                np.asarray(js[key]).dtype.name, key
        want = n(jl)
        ulp = 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(n(pl), want, rtol=0, atol=8 * ulp)

    def test_vlm_prefill_drops_the_image_prefix(self, codes):
        # The reference's prefill embeds only the tokens (ROADMAP.md,
        # "Reference state"), while forward_train prepends the projected
        # image tokens: the two disagree at the last position, in both
        # packages alike.
        jcfg, japi, params, _, api, model = zoo("internvl2-1b")
        jb, pb = batch_of(jcfg, s=PROMPT)
        train, _ = api.forward_train(model, pb)
        text_only, _ = api.forward_train(
            model, {"tokens": pb["tokens"], "frontend": pb["frontend"][:, :0]})
        codes["port"].clear()
        pre, _ = api.prefill(model, pb["tokens"], PROMPT,
                             frontend=pb["frontend"])
        jpre, _ = japi.prefill(params, jb["tokens"], PROMPT,
                               frontend=jb["frontend"])
        assert_close_or_flipped(pre, jpre, first_flip(codes), "internvl2")
        assert np.abs(n(pre)[:, -1] - n(train)[:, -1]).max() > 0.1
        np.testing.assert_allclose(n(pre), n(text_only), **F32_TOL)

    def test_cross_entropy_loss(self):
        logits, labels = normal(2, 5, 30), np.arange(10).reshape(2, 5)
        want = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
        got = cross_entropy_loss(t(logits), t(labels))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)

    @pytest.mark.parametrize("arch", RECURRENT)
    def test_decode_continues_prefill(self, arch):
        # float32 without fake-quant: one decode step after a prefill of
        # S - 1 tokens gives the prefill of S's last logits and its state
        jcfg, _, _, _, api, model = zoo(arch, dcim_enabled=False)
        _, pb = batch_of(jcfg, s=PROMPT + 1)
        want, full = api.prefill(model, pb["tokens"], PROMPT + 1)
        _, state = api.prefill(model, pb["tokens"][:, :-1], PROMPT + 1)
        got, state = api.decode_step(model, state, pb["tokens"][:, -1:])
        np.testing.assert_allclose(n(got[:, -1]), n(want[:, -1]), **F32_TOL)
        for key in full:
            np.testing.assert_allclose(n(state[key]), n(full[key]),
                                       err_msg=key, **F32_TOL)

    @pytest.mark.parametrize("arch", ("granite-moe-1b-a400m", "rwkv6-7b",
                                      "zamba2-1.2b"))
    def test_family_decode_state_layout(self, arch):
        # the recurrent states keep the reference's dtypes: token shifts
        # and conv caches in the compute dtype, wkv / ssd in float32
        replace = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
        jcfg = jax_configs.smoke_config(arch).replace(**replace)
        api = get_model(port_configs.smoke_config(arch).replace(**replace))
        want = values_of(jax_get_model(jcfg).init_decode_state(3, 10))
        got = api.init_decode_state(3, 10, device="cpu")
        assert sorted(got) == sorted(want)
        for key, x in got.items():
            assert tuple(x.shape) == want[key].shape, key
            assert str(x.dtype).removeprefix("torch.") == \
                want[key].dtype.name, key
            assert not x.any(), key

    @pytest.mark.parametrize("arch", RECURRENT)
    def test_recurrent_decode_state_round_trip(self, arch):
        jcfg, japi, params, pcfg, *_ = zoo(arch)
        _, state = japi.prefill(params, batch_of(jcfg)[0]["tokens"], S + 2)
        tree = jax.tree.map(np.asarray, state)
        got = decode_state_from_numpy(pcfg, tree, device="cpu")
        f32 = {"rwkv6-7b": "wkv", "zamba2-1.2b": "ssd"}[arch]
        assert got[f32].dtype == torch.float32
        back = decode_state_to_numpy(got)
        for key in tree:
            np.testing.assert_array_equal(back[key], tree[key])
        with pytest.raises(ValueError, match="no decode state"):
            decode_state_from_numpy(pcfg, dict(tree, extra=tree["pos"]),
                                    device="cpu")

    def test_zamba2_carries_one_shared_block(self):
        # one set of shared-attention weights serves every invocation site,
        # each with its own KV cache
        jcfg, japi, params, pcfg, api, model = zoo("zamba2-1.2b")
        assert "shared_attn" in params and "shared_attn" not in \
            params["mamba"]
        n_shared = sum(p.numel() for p in model.shared_attn.parameters())
        n_jax = sum(x.size for x in jax.tree.leaves(params["shared_attn"]))
        assert n_shared == n_jax
        assert sum(x.size for x in jax.tree.leaves(params)) == \
            sum(p.numel() for p in model.parameters())
        sites = len(range(0, pcfg.n_layers, pcfg.attn_every))
        state = api.init_decode_state(B, 8, device="cpu")
        assert state["k"].shape[0] == sites == 2
        _, state = api.prefill(model, batch_of(jcfg, s=6)[1]["tokens"], 8)
        assert not torch.equal(state["k"][0], state["k"][1])

    def test_init_params_draws_the_law(self):
        cfg = port_configs.smoke_config("whisper-tiny")
        api = get_model(cfg)
        a = api.init_params(torch.Generator().manual_seed(SEED),
                            device="cpu")
        b = api.init_params(device="cpu")
        for (name, x), (_, y) in zip(a.named_parameters(),
                                     b.named_parameters()):
            assert torch.equal(x, y), name
            if name.endswith(".g"):
                assert torch.equal(x, torch.ones_like(x)), name
        jax_n = sum(x.size for x in jax.tree.leaves(zoo("whisper-tiny")[2]))
        assert sum(p.numel() for p in a.parameters()) == jax_n
        assert a.frontend_proj.w.shape == (cfg.frontend.d_frontend,
                                           cfg.d_model)
        assert len(a.enc_blocks) == cfg.encoder_layers

    def test_init_decode_state_layout(self):
        jcfg, japi, *_ = zoo("whisper-tiny")
        api = get_model(port_configs.smoke_config("whisper-tiny"))
        want = values_of(japi.init_decode_state(3, 10))
        got = api.init_decode_state(3, 10, device="cpu")
        assert sorted(got) == sorted(want)
        for key, x in got.items():
            assert tuple(x.shape) == want[key].shape, key
            assert str(x.dtype).removeprefix("torch.") == \
                want[key].dtype.name, key

    def test_decode_state_round_trip(self):
        jcfg, japi, params, pcfg, *_ = zoo("qwen3-4b")
        _, state = japi.prefill(params, batch_of(jcfg)[0]["tokens"], S + 2)
        tree = jax.tree.map(np.asarray, state)
        got = decode_state_from_numpy(pcfg, tree, device="cpu")
        assert got["pos"].dtype == torch.int32
        back = decode_state_to_numpy(got)
        for key in tree:
            np.testing.assert_array_equal(back[key], tree[key])

    def test_convert_rejects_a_bad_tree(self):
        jcfg, _, params, pcfg, *_ = zoo("qwen3-4b")
        tree = jax.tree.map(np.asarray, params)
        missing = {k: v for k, v in tree.items() if k != "ln_f"}
        with pytest.raises(ValueError, match="not given"):
            model_params_from_numpy(pcfg, missing, device="cpu")
        bad = dict(tree, ln_f={"g": np.ones(3, np.float32)})
        with pytest.raises(ValueError, match="shape"):
            model_params_from_numpy(pcfg, bad, device="cpu")
        bad = dict(tree, ln_f={"g": tree["ln_f"]["g"].astype(np.float64)})
        with pytest.raises(ValueError, match="dtype"):
            model_params_from_numpy(pcfg, bad, device="cpu")
        with pytest.raises(ValueError, match="no parameter"):
            model_params_from_numpy(pcfg, dict(tree, extra={"w": 0}),
                                    device="cpu")

    def test_model_needs_a_device_or_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is visible")
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            Transformer(port_configs.smoke_config("qwen3-4b"))


# ---------------------------------------------------------------------------
# 4. configs
# ---------------------------------------------------------------------------

PORT_ARCHS = ARCHS


def test_port_carries_seven_configs():
    # since the rest of the zoo was ported: all ten of the reference's
    assert sorted(port_configs.list_archs()) == sorted(PORT_ARCHS)
    assert port_configs.list_archs() == jax_configs.list_archs()


@pytest.mark.parametrize("arch", PORT_ARCHS)
def test_configs_equal_the_reference(arch):
    for get in ("get_config", "smoke_config"):
        got = getattr(port_configs, get)(arch)
        want = getattr(jax_configs, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()


def test_qwen3_4b_full_width_size():
    cfg = port_configs.get_config("qwen3-4b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.d_ff, cfg.vocab_padded) == (36, 2560, 32, 8, 128, 9728,
                                            151_936)
    model = Transformer(cfg, device="meta")
    n_params = sum(p.numel() for p in model.parameters())
    norms = cfg.n_layers * (2 * cfg.d_model + 2 * cfg.hd) + cfg.d_model
    assert n_params == cfg.param_count() + norms == 4_411_424_256
    assert round(n_params * 2 / 1e9, 2) == 8.82      # GB in bfloat16


@pytest.mark.parametrize("arch", ("granite-moe-1b-a400m",
                                  "granite-moe-3b-a800m", "rwkv6-7b",
                                  "zamba2-1.2b"))
def test_full_width_parameters_equal_the_reference(arch):
    # the full config's parameters, counted on the meta device, against the
    # reference's tree from jax.eval_shape (nothing allocated): the same
    # count and the same bytes per dtype (bf16 weights, f32 norms and
    # recurrence constants)
    jcfg = jax_configs.get_config(arch)
    tree = jax.eval_shape(
        lambda key: values_of(jax_get_model(jcfg).init_params(key)),
        jax.random.PRNGKey(SEED))
    want: dict = {}
    for x in jax.tree.leaves(tree):
        want[x.dtype.name] = want.get(x.dtype.name, 0) + math.prod(x.shape)
    cfg = port_configs.get_config(arch)
    model = model_class(cfg)(cfg, device="meta")
    got: dict = {}
    for p in model.parameters():
        key = str(p.dtype).removeprefix("torch.")
        got[key] = got.get(key, 0) + p.numel()
    assert got == want
