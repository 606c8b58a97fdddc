"""BENCHMARK.json and every file it names, found by name, within the
benchmark contract's limits (names, units, bounds, keys, run length)."""

import json
import math
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.lib import manifest  # noqa: E402

M = manifest.load_manifest()
CELLS = [w["name"] for w in M["workloads"]]
METRICS = M["end_to_end"] + M["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "perfbench/run.py"]
    assert M["paths"] == ["perfbench"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    rs = M["run_seconds"]
    assert 1 <= rs <= 51 and isinstance(rs, int)
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", M["configs"] + M["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"]), entry["name"]
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry and entry is not None:
            text = entry[key]
            assert 1 <= len(text) <= 200 and "\n" not in text \
                and "\t" not in text


def test_names_unique():
    for group in (M["configs"], M["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    keys = {"name", "unit", "better", "source"}
    if metric in M["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0 < metric["bound"] <= 0.25
        keys |= {"bound"}
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert metric["moves"] in {m["name"] for m in M["end_to_end"]}
        keys |= {"layer", "moves"}
    assert set(metric) - {"workloads"} == keys
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    # found by name
    assert callable(manifest.load_reader(metric["name"]))


def test_roofline_and_mfu_names_are_percent():
    for m in METRICS:
        if m["name"].split(".")[0].endswith("_roofline_pct") \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = manifest.load_cell(cell)
    assert c.chips == 1
    assert c.traffic["kind"] == "decode_pool"
    assert callable(manifest.load_kind(c.traffic).Pool)
    assert c.check["compare"]
    family = c.config["family"]
    ref = manifest.load_family("reference", family)
    counts = manifest.load_family("counts", family)
    for fn in ("sample", "hidden", "unembed"):
        assert callable(getattr(ref, fn))
    assert callable(counts.decode_step)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


@pytest.mark.parametrize("cfg", M["configs"], ids=lambda c: c["name"])
def test_config_file_is_what_runs(cfg):
    path = ROOT / cfg["file"]
    assert path.parts[len(ROOT.parts)] == "perfbench"
    data = json.loads(path.read_text())
    assert data["name"] == cfg["name"]
    assert data["reduced"] == cfg["reduced"]
    assert len(cfg["reduced"]) <= 16
    for key in cfg["reduced"]:
        # a changed key is in the file, with what runs, and is no width
        assert NAME.match(key) and key in data
        assert any(key in k or key in v for k, v in data["assumed"].items())
        assert not re.search(r"(_dim$|_rank$|_size$|d_state|head|expand"
                             r"|experts_per_tok)", key), key
    port, src = data["port"], data
    # the published numbers at the top level are the ones the port runs
    assert port["d_model"] == src["hidden_size"]
    assert port["n_layers"] == src["num_hidden_layers"]
    assert port["n_heads"] == src["num_attention_heads"]
    assert port["n_kv_heads"] == src["num_key_value_heads"]
    assert port["head_dim"] == src.get("head_dim",
                                       src.get("attention_head_dim"))
    assert port["vocab"] == src["vocab_size"]
    assert math.isclose(port["rope_theta"], src["rope_theta"])
    if "moe" in port:
        assert port["moe"]["n_experts"] == src["num_local_experts"]
        assert port["moe"]["top_k"] == src["num_experts_per_tok"]
        assert port["moe"]["d_expert"] == src["intermediate_size"]
    if "ssm" in port:
        assert port["d_ff"] == src["ffn_hidden_size"]
        assert port["ssm"]["state"] == src["mamba_d_state"]
        assert port["ssm"]["head_dim"] == src["mamba_headdim"]
        assert port["ssm"]["expand"] == src["mamba_expand"]
        assert port["ssm"]["conv_kernel"] == src["mamba_d_conv"]
        assert port["attn_every"] == src["shared_block_every"]
        assert port["n_heads"] * port["head_dim"] \
            == src["attention_hidden_size"]


@pytest.mark.parametrize("cfg", M["configs"], ids=lambda c: c["name"])
def test_config_builds_the_ports_arch_with_its_parameter_count(cfg):
    from perfbench.run import build_config
    from repro_torch.models import model_class

    data = json.loads((ROOT / cfg["file"]).read_text())
    arch = build_config(data)
    model = model_class(arch)(arch, device="meta")
    assert sum(p.numel() for p in model.parameters()) == data["parameters"]


def test_paths_hold_only_the_benchmark():
    for p in (ROOT / "perfbench").rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel
