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
import repro.quant.quantizers as JQ
from repro.models import cross_entropy_loss as jax_cross_entropy
from repro.models import get_model as jax_get_model
from repro.models import layers as JL
from repro.parallel.logical import values_of

import repro_torch.configs as port_configs
import repro_torch.quant.quantizers as TQ
from repro_torch.convert import (decode_state_from_numpy,
                                 decode_state_to_numpy,
                                 model_params_from_numpy)
from repro_torch.models import cross_entropy_loss, get_model
from repro_torch.models import layers as TL
from repro_torch.models.transformer import Transformer
from repro_torch.quant import (QuantSpec, block_fp_align, dequantize,
                               fake_quant, fp8_e4m3_quant, quantize_int)
from repro_torch.serve import greedy_generate

REPO = pathlib.Path(__file__).resolve().parents[1]
SEED = 0
ARCHS = ("qwen3-4b", "llama3.2-3b", "phi3-mini-3.8b", "mistral-large-123b",
         "internvl2-1b", "whisper-tiny")
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
    ``lax.scan`` traces)."""
    rec = {"jax": [], "port": []}
    jax_q, port_q = JQ.quantize_int, TQ.quantize_int

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
    return rec


def first_flip(rec) -> tuple[int, int, int] | None:
    """(call index, flipped codes, codes in the call) of the first
    fake-quant call whose codes differ, or None.  Every earlier call agrees
    bit for bit; the first differing one may differ only by one code step
    in at most ``FLIP_CODES`` of its codes."""
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
    return None


def assert_close_or_flipped(got, want, flip, what: str) -> None:
    """The 1e-5 tolerance without a flip; with one, FLIP_FRAC of the
    reference's largest magnitude (module doc), and the flip printed."""
    got, want = n(got), n(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if flip is None:
        np.testing.assert_allclose(got, want, err_msg=what, **F32_TOL)
        return
    call, flips, size = flip
    print(f"{what}: fake-quant flip at call {call}: {flips} of {size} "
          f"codes; max |diff| {np.abs(got - want).max():.6g}")
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

    @pytest.mark.parametrize("family", ("moe", "ssm", "hybrid"))
    def test_unported_families_raise(self, family):
        cfg = port_configs.smoke_config("qwen3-4b").replace(family=family)
        with pytest.raises(NotImplementedError, match="queue 1, item 7"):
            get_model(cfg)
        with pytest.raises(NotImplementedError, match="queue 1, item 7"):
            get_model(port_configs.get_config("zamba2-1.2b"))

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

PORT_ARCHS = ARCHS + ("zamba2-1.2b",)


def test_port_carries_seven_configs():
    assert sorted(port_configs.list_archs()) == sorted(PORT_ARCHS)
    assert set(port_configs.list_archs()) < set(jax_configs.list_archs())


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
