"""RWKV-6 Finch as published (the port's family ``finch``,
``models.rwkv6.Finch``) on the CPU at the smoke size in float32, with
weights drawn by the ``rwkv6-7b`` configuration's laws: prefill and decode
against the benchmark's plain reference (``perfbench/reference/rwkv6.py``,
the sequential WKV recurrence), the full-width parameter count, the
chunk's margin, the layer spans of one traced decode step, and the
decode step's FLOPs and bytes (``perfbench/counts/rwkv6.py``) by hand."""

import json
import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.counts import rwkv6 as counts  # noqa: E402
from perfbench.lib.weights import draw, specs_of  # noqa: E402
from perfbench.reference import rwkv6 as reference  # noqa: E402
from perfbench.reference.common import exact  # noqa: E402
from perfbench.run import build_config, port_of  # noqa: E402
from repro_torch.configs import (SUBQUADRATIC_FAMILIES, get_config,  # noqa: E402
                                 smoke_config)
from repro_torch.configs.base import finch_lora_ranks  # noqa: E402
from repro_torch.models import get_model, model_class  # noqa: E402
from repro_torch.models.rwkv6 import RWKV6, Finch  # noqa: E402
from repro_torch.obs import tracer  # noqa: E402
from repro_torch.serve.step import (greedy_argmax, make_decode_step,  # noqa: E402
                                    make_prefill)

CONFIG = json.loads((ROOT / "perfbench" / "configs" / "rwkv6-7b.json")
                    .read_text())


def _smoke():
    return smoke_config("rwkv6-7b").replace(family="finch")


def _model(cfg, seed=5):
    model = model_class(cfg)(cfg, device="meta")
    w = draw(specs_of(model), CONFIG["init"], seed, "cpu")
    model.load_state_dict(w, strict=True, assign=True)
    return model, w


def test_finch_is_reached_through_the_registry():
    cfg = _smoke()
    assert model_class(cfg) is Finch and issubclass(Finch, RWKV6)
    assert model_class(smoke_config("rwkv6-7b")) is RWKV6
    assert "finch" in SUBQUADRATIC_FAMILIES
    arch = build_config(CONFIG)
    assert arch.family == "finch" and arch.ssm.chunk == 32
    assert arch.name == "rwkv6-7b"
    # the model's own draw (``init_params``) serves too
    api = get_model(cfg)
    model = api.init_params(torch.Generator().manual_seed(0), device="cpu")
    assert isinstance(model, Finch)
    assert torch.all(model.blocks[0].w0 <= -1.0)
    with torch.no_grad():
        logits, state = api.prefill(model, torch.zeros((2, 40),
                                                       dtype=torch.long), 0)
    assert torch.isfinite(logits).all() and state["wkv"].shape[0] == 2


def _codes(monkeypatch) -> dict:
    """Record the int8 activation codes of every DCIM linear, in call
    order: the port's (``models.layers``' fake-quant) and the reference's
    (``reference.common``'s)."""
    import repro_torch.models.layers as layers
    from perfbench.reference import common

    rec = {"port": [], "ref": []}

    def spy(real, side):
        def fake_quant(x, bits, axis):
            if axis == -1:
                qmax = (1 << (bits - 1)) - 1
                xf = x.float()
                s = torch.clamp(xf.abs().amax(dim=-1, keepdim=True),
                                min=1e-8) / qmax
                rec[side].append(torch.round(xf / s))
            return real(x, bits, axis)
        return fake_quant

    monkeypatch.setattr(layers, "fake_quant", spy(layers.fake_quant, "port"))
    monkeypatch.setattr(common, "fake_quant", spy(common.fake_quant, "ref"))
    return rec


def _first_flip(rec: dict, calls: int, steps: int) -> torch.Tensor:
    """Per sequence, the first position at which a DCIM linear's
    activation codes differ between the port and the reference (the
    positions' count where none does); each such first difference is one
    code step.  The port's prefill and each of its ``steps`` decode steps
    make ``calls`` calls, the reference's one pass ``calls``."""
    ref = rec["ref"]
    assert len(ref) == calls and len(rec["port"]) == calls * (1 + steps)
    port = [torch.cat(rec["port"][i::calls], dim=1) for i in range(calls)]
    b, t = ref[0].shape[:2]
    first = torch.full((b,), t)
    for p, r in zip(port, ref):
        differ = (p != r).any(dim=-1)                       # (b, t)
        at = torch.where(differ.any(dim=1), differ.float().argmax(dim=1),
                         torch.tensor(t))
        first = torch.minimum(first, at)
    for p, r in zip(port, ref):
        for n in range(b):
            if first[n] < t:
                gap = (p[n, first[n]] - r[n, first[n]]).abs()
                assert gap.max() <= 1, "a flip of more than one code"
    return first


@pytest.mark.parametrize("dcim", [False, True])
@pytest.mark.parametrize("prompt_len", [9, 32, 77])
def test_prefill_then_decode_follows_the_reference(prompt_len, dcim,
                                                   monkeypatch):
    # prompts shorter than the smoke chunk (32), one chunk, and several
    # chunks with a remainder; then 6 decode steps through the state
    cfg = _smoke().replace(dcim_enabled=dcim)
    assert cfg.ssm.chunk == 32
    model, w = _model(cfg)
    api = get_model(cfg)
    b, g = 4, 7
    prompts = torch.randint(0, cfg.vocab, (b, prompt_len),
                            generator=torch.Generator().manual_seed(1))
    if not dcim:
        monkeypatch.setattr(reference, "dcim_linear",
                            lambda x, wt, rnd: rnd(x @ wt.float()))
    rec = _codes(monkeypatch)
    with torch.no_grad():
        logits, state = make_prefill(api, prompt_len + g)(model, prompts)
        outs, tok = [logits[:, -1]], greedy_argmax(logits)
        toks = [tok]
        decode = make_decode_step(api)
        for _ in range(g - 1):
            logits, state = decode(model, state, tok)
            outs.append(logits[:, -1])
            tok = greedy_argmax(logits)
            toks.append(tok)
        port = torch.stack(outs, 1).float()
        ccfg = dict(CONFIG, port=port_of(cfg, CONFIG["port"]))
        h = reference.hidden(ccfg, w, torch.cat([prompts] + toks, 1),
                             prompt_len, b, exact)
        want = h @ reference.unembed(ccfg, w).T
    assert int(state["pos"]) == prompt_len + g - 1
    # the chunked prefill and the eager decode against the sequential
    # recurrence, both in float32: the same logits but for float32's
    # rounding of sums taken in another order (logits of magnitude ~4;
    # the widest difference reads ~2e-6)
    diff = (want - port).abs().amax(dim=-1)                 # (b, g)
    if not dcim:
        assert diff.max() < 2e-5
        return
    # with fake-quant on, an activation that float32's rounding leaves at
    # an int8 rounding tie may take the next code on one side: from that
    # position on the logits move by a code's worth (~0.03 at this size),
    # every earlier one agrees within 2e-5
    first = _first_flip(rec, 8 * cfg.n_layers, g - 1)
    before = torch.arange(g)[None, :] + prompt_len - 1 < first[:, None]
    assert (diff[before] < 2e-5).all(), diff
    assert diff.max() < 0.1


def test_full_width_parameter_count_is_the_published_shapes():
    cfg = build_config(CONFIG)
    n = sum(p.numel() for p in Finch(cfg, device="meta").parameters())
    d, ff, v, layers = 4096, 14336, 65536, 32
    r_mix, r_decay = 64, 128
    per_layer = (5 * d * d                    # receptance, key, value,
                                              # gate, output
                 + d * ff + ff * d + d * d    # channel-mix key, value,
                                              # receptance
                 + d * 5 * r_mix + 5 * r_mix * d   # time_maa_w1, _w2
                 + d * r_decay + r_decay * d       # time_decay_w1, _w2
                 + 6 * d                      # time_maa_x, _w, _k, _v, _r, _g
                 + d + d                      # time_decay, time_faaaa
                 + 2 * d                      # ln_x (GroupNorm)
                 + 2 * d                      # channel-mix time_maa_k, _r
                 + 4 * d)                     # ln1, ln2
    published = layers * per_layer + 2 * v * d + 4 * d   # emb, head, ln0,
                                                          # ln_out
    assert n == published == CONFIG["parameters"] == 7_635_746_816
    assert finch_lora_ranks(d) == (CONFIG["time_mix_extra_dim"],
                                   CONFIG["time_decay_extra_dim"])
    assert finch_lora_ranks(64) == (32, 64)
    # the analytical count is the matrices'
    assert cfg.param_count() == n - layers * 16 * d - 4 * d


def test_chunk_keeps_the_summed_decay_inside_float32():
    # the decay's exponent is w0 + tanh(.) decay_w2 <= max w0 + rank x the
    # widest decay_w2 entry, whatever the activations: over a chunk the
    # summed |log w| stays clear of float32's largest exponent, and of its
    # denormals (exp of the negated sum) on the other side
    laws = dict((pat, law) for pat, law in CONFIG["init"])
    w0_max = laws["*.w0"]["uniform"][1]
    b_max = max(abs(x) for x in laws["*.decay_w2"]["uniform"])
    bound = math.exp(w0_max + CONFIG["time_decay_extra_dim"] * b_max)
    chunk = CONFIG["port"]["ssm"]["chunk"]
    big = math.log(torch.finfo(torch.float32).max)        # 88.72
    tiny = -math.log(torch.finfo(torch.float32).tiny)     # 87.34
    assert chunk * bound < 0.5 * min(big, tiny)
    assert 2 * chunk * bound > 0.95 * tiny                 # 64 would not do


def test_worst_case_decay_prefills_finite():
    # every decay at the bound's worst case (the exponent at max w0 + rank
    # x the widest decay_w2 entry, 0.28, for every channel and token): a
    # 4-chunk prefill at the configuration's chunk stays finite and
    # follows the reference
    cfg = _smoke().replace(ssm=_smoke().ssm.__class__(
        state=16, head_dim=16, chunk=CONFIG["port"]["ssm"]["chunk"]))
    model, _ = _model(cfg, seed=9)
    with torch.no_grad():
        for blk in model.blocks:
            blk.w0.fill_(-1.0 + CONFIG["time_decay_extra_dim"] * 0.01)
            blk.decay_w2.zero_()
    w = dict(model.state_dict())
    prompts = torch.randint(0, cfg.vocab, (2, 4 * cfg.ssm.chunk),
                            generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        logits, state = get_model(cfg).prefill(model, prompts, 0)
        ccfg = dict(CONFIG, port=port_of(cfg, CONFIG["port"]))
        h = reference.hidden(ccfg, w, torch.cat([prompts, prompts[:, :1]],
                                                1), prompts.shape[1], 2,
                             exact)
        want = h @ reference.unembed(ccfg, w).T
    assert torch.isfinite(logits).all() and torch.isfinite(state["wkv"]).all()
    assert (want[:, 0] - logits[:, -1]).abs().max() < 2e-5


def test_one_traced_decode_step_records_the_finch_spans():
    cfg = _smoke()
    model, _ = _model(cfg)
    api = get_model(cfg)
    prompts = torch.randint(0, cfg.vocab, (4, 8),
                            generator=torch.Generator().manual_seed(1))
    clock = tracer.clock
    tracer.configure(enabled=False)
    tracer.clear()
    try:
        with torch.no_grad():
            logits, state = make_prefill(api, 16)(model, prompts)
            assert tracer.spans() == []               # tracing off
            tracer.configure(enabled=True)
            make_decode_step(api)(model, state, greedy_argmax(logits))
        spans = tracer.spans()
    finally:
        tracer.configure(enabled=False, clock=clock)
        tracer.clear()
    (root,) = [s for s in spans if s.parent_id is None]
    assert root.name == "serve.decode_step"
    by_id = {s.span_id: s for s in spans}
    for name, parent in (("rwkv.time_mix", "serve.decode_step"),
                         ("rwkv.wkv", "rwkv.time_mix"),
                         ("rwkv.channel_mix", "serve.decode_step")):
        mine = [s for s in spans if s.name == name]
        assert len(mine) == cfg.n_layers, name
        assert {by_id[s.parent_id].name for s in mine} == {parent}
        assert all(s.trace_id == root.trace_id for s in mine)
    # the eight DCIM linears' weight and activation fake-quants, inside
    # the two mixes (none inside the WKV)
    fq = [s for s in spans if s.name == "fake_quant"]
    assert len(fq) == 16 * cfg.n_layers
    assert {by_id[s.parent_id].name for s in fq} \
        == {"rwkv.time_mix", "rwkv.channel_mix"}


def test_decode_step_counts_by_hand():
    # d 64, 4 heads of 16, d_ff 128, vocab 256, 2 layers; ranks 32 and 64
    port = {"d_model": 64, "n_heads": 4, "head_dim": 16, "d_ff": 128,
            "vocab": 256, "n_layers": 2, "param_dtype": "bfloat16",
            "compute_dtype": "bfloat16"}
    proj = 6 * 64 * 64 + 2 * 64 * 128                  # 40,960
    lora = 64 * 160 + 160 * 64 + 64 * 64 + 64 * 64     # 28,672
    assert (proj, lora) == (40_960, 28_672)
    per_token = 2 * (2 * (proj + lora) + 256 * 64) \
        + 2 * 5 * 4 * 16 * 16                          # WKV: 5 H dk dv
    weights = 2 * ((proj + lora) * 2 + 16 * 64 * 4) \
        + 2 * 256 * 64 * 2 + 4 * 64 * 4
    per_seq = 2 * (2 * 4 * 16 * 16 * 4                 # WKV read, written
                   + 2 * 2 * 64 * 2) + 256 * 2          # two shifts; logits
    got = counts.decode_step(port, 8, 100)
    assert got == {"flops": 8 * per_token, "bytes": weights + 8 * per_seq}
    assert got == {"flops": 8 * 321_536, "bytes": 353_280 + 8 * 17_920}
    # the step does not grow with the context
    assert counts.decode_step(port, 8, 5000) == got


def test_full_config_of_the_jax_package_is_untouched():
    # the JAX package's rwkv6-7b (the port's family ``ssm``) is what the
    # configuration names as its ``arch``; only the family differs
    assert get_config("rwkv6-7b").family == "ssm"
    assert build_config(CONFIG) == get_config("rwkv6-7b").replace(
        family="finch", ssm=build_config(CONFIG).ssm)
