"""The plain references against the port on its smoke configurations, and
the comparison that decides ``correct`` against its control and against a
timed path broken on purpose, on the CPU at a small size.

The smoke configurations compute in float32, so the port agrees with the
reference there to float32's rounding, and the control is the reference
in the precision below (bfloat16).  The limits at this size are set as
the cells' are on the card (``PERF.md``), from readings at this size on
seeds 3, 7, 11 and 2**35 + 1, each over every one of the first 20 jobs of
32 sequences x 24 served tokens: granite's widest gap reads at most 0.0128
in sound runs and at least 0.0318 in the control, its mean gap 1.7e-5 and
2.0e-4; zamba2's mean gap 7.6e-5 and 2.2e-3, its median of each
sequence's widest gap 0 and 0.022.  Jobs are short, so that a window
finishes several and the comparison covers a whole job."""

import dataclasses
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.lib import manifest  # noqa: E402
from perfbench.lib.weights import draw, specs_of  # noqa: E402
from perfbench.reference.common import exact  # noqa: E402
from perfbench.run import port_of, run_cell  # noqa: E402

ARCH = {"granite-moe-3b.decode": "granite-moe-3b-a800m",
        "zamba2-1.2b.decode": "zamba2-1.2b"}
SMALL = {"batch": 32, "prompt_len": 8, "output_len": 24, "cache_len": 32}
LIMITS = {"granite-moe-3b.decode": {"widest_gap": 0.02, "mean_gap": 8e-5},
          "zamba2-1.2b.decode": {"mean_gap": 5e-4, "seq_widest_median": 0.01}}


def _smoke(name):
    from repro_torch.configs import smoke_config

    return smoke_config(ARCH[name])


@pytest.mark.parametrize("name", sorted(ARCH))
def test_reference_follows_the_port_through_prefill_and_decode(name):
    from repro_torch.models import get_model, model_class
    from repro_torch.serve.step import greedy_argmax

    cell = manifest.load_cell(name)
    cfg = _smoke(name)
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
    # every decode step's MoE capacity groups and every recurrent state
    # followed: float32's rounding apart, the same logits
    assert (logits_ref - port).abs().max() < 2e-5


def test_weights_are_drawn_again_bit_for_bit():
    cell = manifest.load_cell("zamba2-1.2b.decode")
    from repro_torch.models import model_class

    cfg = _smoke("zamba2-1.2b.decode")
    specs = specs_of(model_class(cfg)(cfg, device="meta"))
    a = draw(specs, cell.config["init"], 2**40 + 3, "cpu")
    b = draw(specs, cell.config["init"], 2**40 + 3, "cpu")
    c = draw(specs, cell.config["init"], 2**40 + 4, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed.emb"], c["embed.emb"])
    assert torch.all(a["mamba.0.A_log"] == 0)
    assert a["mamba.0.conv_w"].abs().max() <= 0.5


def _cell(name):
    cell = manifest.load_cell(name)
    check = dict(cell.check, compare={k: {"limit": LIMITS[name][k]}
                                      for k in cell.check["compare"]})
    return dataclasses.replace(cell, traffic=dict(cell.traffic, **SMALL),
                               check=check)


def _run(name, seed, **kw):
    return run_cell(_cell(name), seed, 2.0, False, "cpu",
                    time.perf_counter(), config=_smoke(name), **kw)


@pytest.mark.parametrize("seed", [3, 2**35 + 1])
@pytest.mark.parametrize("name", sorted(ARCH))
def test_sound_runs_are_correct_and_the_control_is_not(name, seed):
    out = _run(name, seed, control=True)
    assert out["info"]["compared"]["positions"] \
        == SMALL["batch"] * SMALL["output_len"]         # a whole job
    assert out["correct"], out["checks"]
    # the control on the same prompts and tokens, through the same check:
    # not correct
    ctrl = out["info"]["control"]
    assert ctrl["correct"] is False, ctrl["checks"]
    number = next(iter(out["checks"]))
    assert ctrl["checks"][number]["value"] > ctrl["checks"][number]["limit"]
    assert ctrl["checks"][number]["limit"] == LIMITS[name][number]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered"])
@pytest.mark.parametrize("name", sorted(ARCH))
def test_a_broken_timed_path_is_not_correct(name, fault):
    out = _run(name, 7, fault=fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [None, "half_batch"])
def test_granite_compares_every_decode_group(monkeypatch, fault):
    # four decode groups of 8 sequences: the reference follows each group
    # as the program routed it, and a fault in any part of the batch shows
    import repro_torch.models.moe as moe_model

    name = "granite-moe-3b.decode"
    monkeypatch.setattr(moe_model, "MOE_GROUP", 8)
    cell = _cell(name)
    port = dict(cell.config["port"], moe_group_tokens=8)
    cell = dataclasses.replace(cell, config=dict(cell.config, port=port))
    out = run_cell(cell, 11, 2.0, False, "cpu", time.perf_counter(),
                   config=_smoke(name), fault=fault)
    assert out["info"]["compared"]["sequences"] == SMALL["batch"]
    assert out["correct"] is (fault is None), out["checks"]
