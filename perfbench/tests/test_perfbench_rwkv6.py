"""The ``rwkv6-7b`` configuration and its cell ``rwkv6-7b.decode`` in the
harness, on the CPU at the smoke size in float32: the configuration file
against the published keys and the port it builds, the cell's files and
manifest entries, the plain reference against the port through the
harness, the comparison that decides ``correct`` against its control and
against a timed path broken on purpose, the result line of a run and of a
traced run, the four ``rwkv_*`` readers on a record built by hand, and
the decode step's counts at full width by hand.

Limits at this size are set as the cell's are on the card (``PERF.md``),
from readings at this size on seeds 3, 7, 11 and 2**35 + 1, each over
every one of the first 20 jobs of 32 sequences x 24 served tokens: the
mean gap reads at most 6.7e-5 in sound runs and at least 3.8e-4 in the
control (the reference in bfloat16); the median of each sequence's
widest gap reads 0 in both, so its limit only keeps sound runs correct
(an activation that float32 leaves at an int8 rounding tie takes the
next code on one side, which moves a few gaps to 0.04: the widest gap
cannot tell the two apart at this size)."""

import dataclasses
import json
import re
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.counts import rwkv6 as counts  # noqa: E402
from perfbench.lib import manifest  # noqa: E402
from perfbench.lib.weights import draw, law_of, specs_of  # noqa: E402
from perfbench.reference.common import exact  # noqa: E402
from perfbench.run import build_config, port_of, run_cell  # noqa: E402
from repro_torch.obs import tracer  # noqa: E402

CELL = "rwkv6-7b.decode"
M = manifest.load_manifest()
DATA = json.loads((ROOT / "perfbench" / "configs" / "rwkv6-7b.json")
                  .read_text())
SMALL = {"batch": 32, "prompt_len": 8, "output_len": 24, "cache_len": 32}
LIMITS = {"mean_gap": 1.6e-4, "seq_widest_median": 0.01}
READERS = ("rwkv_time_mix_host_ms.decode", "rwkv_time_mix_idle_ms.decode",
           "rwkv_wkv_host_ms.decode", "rwkv_channel_mix_host_ms.decode")
# the accepted metrics whose lists the cell was appended to
SHARED = ("decode_tokens_per_s", "itl_p90_ms", "dispatch_ms.decode",
          "kernels_per_step.decode", "matmul_busy_pct.decode",
          "kernel_roofline_pct.decode", "mfu.decode",
          "device_idle_pct.decode", "fake_quant_host_ms.decode",
          "fake_quant_kernel_pct.decode")


def _smoke():
    """The smoke rwkv6-7b in the family the configuration's ``port`` block
    runs (``finch``)."""
    from repro_torch.configs import smoke_config

    return smoke_config("rwkv6-7b").replace(family=DATA["port"]["family"])


def test_config_file_is_what_runs():
    (entry,) = [c for c in M["configs"] if c["name"] == "rwkv6-7b"]
    assert entry["file"] == "perfbench/configs/rwkv6-7b.json"
    assert "2404.05892" in entry["source"] \
        and "RWKV/v6-Finch-7B-HF" in entry["source"]
    assert DATA["reduced"] == entry["reduced"] == ["rescale_every"]
    for key in DATA["reduced"]:
        assert key in DATA and any(key in k or key in v
                                   for k, v in DATA["assumed"].items())
        assert not re.search(r"(_dim$|_rank$|_size$|head|expand)", key)
    port = DATA["port"]
    # the published numbers at the top level are the ones the port runs
    assert port["d_model"] == DATA["hidden_size"] == 4096
    assert port["n_layers"] == DATA["num_hidden_layers"] == 32
    assert port["head_dim"] == DATA["head_size"] == 64
    assert port["n_heads"] * port["head_dim"] \
        == DATA["attention_hidden_size"]
    assert port["d_ff"] == DATA["intermediate_size"] == 14_336
    assert port["vocab"] == DATA["vocab_size"] == 65_536
    assert port["tie_embeddings"] == DATA["tie_word_embeddings"] is False
    arch = build_config(DATA)
    assert arch.family == "finch" and arch.ssm.chunk == 32
    assert (arch.param_dtype, arch.compute_dtype) == ("bfloat16",
                                                      "bfloat16")
    from repro_torch.models import model_class

    model = model_class(arch)(arch, device="meta")
    specs = specs_of(model)
    assert sum(p.numel() for p in model.parameters()) == DATA["parameters"]
    w1 = dict((n, s) for n, s, _ in specs)
    assert w1["blocks.0.maa_w1"] == (4096, 5 * DATA["time_mix_extra_dim"])
    assert w1["blocks.0.decay_w1"] == (4096, DATA["time_decay_extra_dim"])
    # every parameter has a law, the LoRAs' and lerps' their own
    laws = {n: law_of(n, DATA["init"]) for n, _, _ in specs}
    assert laws["blocks.3.w0"] == {"uniform": [-6.0, -1.0]}
    assert laws["blocks.3.maa_k"] == laws["blocks.3.mu_cr"] \
        == {"uniform": [0.0, 1.0]}
    assert laws["blocks.3.decay_w2"] == {"uniform": [-0.01, 0.01]}
    assert laws["ln0.b"] == {"normal": 0.1}


def test_cell_files_found_by_name():
    c = manifest.load_cell(CELL)
    assert c.chips == 1 and c.config["family"] == "rwkv6"
    assert c.traffic["kind"] == "decode_pool"
    assert (c.traffic["batch"], c.traffic["prompt_len"],
            c.traffic["output_len"], c.traffic["cache_len"]) \
        == (512, 128, 128, 256)
    assert list(c.check["compare"]) == ["mean_gap", "seq_widest_median"]
    ref = manifest.load_family("reference", "rwkv6")
    for fn in ("sample", "hidden", "unembed"):
        assert callable(getattr(ref, fn))
    assert {m["name"] for m in c.end_to_end} \
        == {"decode_tokens_per_s", "itl_p90_ms", "setup_s"}
    assert {m["name"] for m in c.per_layer} == set(SHARED[2:]) | set(READERS)


def test_readers_are_listed_where_they_read():
    per_layer = {m["name"]: m for m in M["per_layer"]}
    for name in READERS:
        m = per_layer[name]
        assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"],
                m["workloads"]) == ("ms", "lower", "program_span", "model",
                                    "decode_tokens_per_s", [CELL])
        assert callable(manifest.load_reader(name))
    for m in M["end_to_end"] + M["per_layer"]:
        if m["name"] in SHARED:
            assert m["workloads"][-1] == CELL


@pytest.fixture
def clean_tracer():
    clock = tracer.clock
    tracer.clear()
    yield
    tracer.configure(enabled=False, clock=clock)
    tracer.clear()


def test_readers_on_a_record_by_hand(clean_tracer):
    # one traced decode step, in ms on the tracer's clock: the root 1-9,
    # the time-mix 2-6 over the WKV 3-4, the channel-mix 6-8; device ops
    # 3-3.5 and 4.5-6.5
    ms = 1_000_000
    tracer.configure(enabled=True, clock=lambda: 0.0)
    root = tracer.start_trace("serve.decode_step", start_s=1e-3)
    tm = tracer.start("rwkv.time_mix", parent=root.context, start_s=2e-3)
    wkv = tracer.start("rwkv.wkv", parent=tm.context, start_s=3e-3)
    wkv.finish(end_s=4e-3)
    tm.finish(end_s=6e-3)
    cm = tracer.start("rwkv.channel_mix", parent=root.context, start_s=6e-3)
    cm.finish(end_s=8e-3)
    root.finish(end_s=9e-3)
    tracer.configure(enabled=False)
    off = root.span.unix_offset_ns

    def ns(t):
        return round(t * ms) + off

    tr = {"window_ns": [ns(0.5), ns(10)],
          "spans": [("decode_call", ns(0.5), ns(9.5)),
                    ("argmax", ns(9.5), ns(9.7)),
                    ("token_copy", ns(9.7), ns(10))],
          "ops": [("k", ns(3), ns(3.5), "kernel"),
                  ("k", ns(4.5), ns(6.5), "kernel")],
          "events": [dict(kind="decode", job=0, t0=0, t_ret=1, t_end=2,
                          tokens=4)]}
    rec = {"setup_s": 1.0, "window_s": 1.0, "events": [], "trace": tr,
           "peaks": None, "matmul_substrings": []}
    want = dict(zip(READERS, (4.0, 2.0, 1.0, 2.0)))
    for name, value in want.items():
        assert manifest.load_reader(name)(rec) == pytest.approx(value)
    # a record without the spans reads nothing
    tracer.clear()
    assert all(manifest.load_reader(n)(rec) is None for n in READERS)


def test_reference_follows_the_port_through_prefill_and_decode():
    from repro_torch.models import get_model, model_class
    from repro_torch.serve.step import greedy_argmax

    cell = manifest.load_cell(CELL)
    cfg = _smoke()
    model = model_class(cfg)(cfg, device="meta")
    w = draw(specs_of(model), cell.config["init"], 5, "cpu")
    model.load_state_dict(w, assign=True)
    api = get_model(cfg)
    b, p, g = 8, 8, 7
    prompts = torch.randint(0, cfg.vocab, (b, p),
                            generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits, state = api.prefill(model, prompts, p + g)
        outs, tok = [logits[:, -1]], greedy_argmax(logits)
        toks = [tok]
        for _ in range(g - 1):
            logits, state = api.decode_step(model, state, tok)
            outs.append(logits[:, -1])
            tok = greedy_argmax(logits)
            toks.append(tok)
        port = torch.stack(outs, 1)[..., :cfg.vocab].float()
        ccfg = dict(cell.config, port=port_of(cfg, cell.config["port"]))
        ref = manifest.load_family("reference", cell.config["family"])
        h = ref.hidden(ccfg, w, torch.cat([prompts] + toks, 1), p, b, exact)
        logits_ref = h @ ref.unembed(ccfg, w).T
    # the recurrent state followed through every decode step: float32's
    # rounding apart, the same logits (no int8 code flips at this seed;
    # tests/test_torch_rwkv6_finch.py follows the flips)
    assert (logits_ref - port).abs().max() < 2e-5


def _cell():
    cell = manifest.load_cell(CELL)
    check = dict(cell.check, compare={k: {"limit": LIMITS[k]}
                                      for k in cell.check["compare"]})
    return dataclasses.replace(cell, traffic=dict(cell.traffic, **SMALL),
                               check=check)


def _run(seed, trace=False, **kw):
    return run_cell(_cell(), seed, 2.0, trace, "cpu", time.perf_counter(),
                    config=_smoke(), **kw)


@pytest.mark.parametrize("seed", [3, 2**35 + 1])
def test_sound_runs_are_correct_and_the_control_is_not(seed):
    out = _run(seed, control=True)
    assert out["info"]["compared"]["positions"] \
        == SMALL["batch"] * SMALL["output_len"]         # a whole job
    assert out["correct"], out["checks"]
    ctrl = out["info"]["control"]
    assert ctrl["correct"] is False, ctrl["checks"]
    assert ctrl["checks"]["mean_gap"]["value"] > LIMITS["mean_gap"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered"])
def test_a_broken_timed_path_is_not_correct(fault):
    out = _run(7, fault=fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("trace_run", [False, True])
def test_result_line_of_a_cpu_run(trace_run):
    cell = _cell()
    out = _run(2**33 + 11, trace=trace_run)
    assert list(out)[-1] == "checks" and out["correct"]
    want = {m["name"]: m["unit"] for m in cell.metrics(trace_run)}
    for name, m in out["metrics"].items():
        assert want[name] == m["unit"]
    if trace_run:
        assert set(READERS) <= set(out["metrics"])
        assert out["metrics"]["rwkv_wkv_host_ms.decode"]["value"] \
            < out["metrics"]["rwkv_time_mix_host_ms.decode"]["value"]
        assert {"busy_s", "window_s"} <= set(out["device"])
    else:
        assert set(want) == set(out["metrics"])
    json.dumps(out)


def test_decode_step_by_hand():
    # a block: r, k, v, g, o 5 x 4096^2; channel-mix k and v 2 x 4096 x
    # 14336 and r 4096^2; the ddlerp LoRA 2 x 4096 x 320, the decay LoRA
    # 2 x 4096 x 128
    block = 6 * 4096 ** 2 + 2 * 4096 * 14_336 + 2 * 4096 * 320 \
        + 2 * 4096 * 128
    per_token = 2 * (32 * block + 65_536 * 4096) + 32 * 5 * 64 * 64 * 64
    weights = 32 * (block * 2 + 16 * 4096 * 4) + 2 * 65_536 * 4096 * 2 \
        + 4 * 4096 * 4
    per_seq = 32 * (2 * 64 * 64 * 64 * 4 + 2 * 2 * 4096 * 2) + 65_536 * 2
    got = counts.decode_step(DATA["port"], 512, 200)
    assert got == {"flops": 512 * per_token,
                   "bytes": weights + 512 * per_seq}
    assert got == {"flops": 7_563_437_408_256, "bytes": 50_239_438_848}
    # the weights are the port's parameters, byte for byte
    from repro_torch.models import model_class

    arch = build_config(DATA)
    model = model_class(arch)(arch, device="meta")
    assert counts.weight_bytes(DATA["port"]) \
        == sum(p.numel() * p.element_size() for p in model.parameters())
