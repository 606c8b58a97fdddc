"""``counts/<family>.py`` against hand counts of both configurations, and
their weight bytes against the port's parameters on the meta device."""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.counts import hybrid, moe  # noqa: E402


def _port(name):
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json")
                      .read_text())["port"]


def test_granite_decode_step_by_hand():
    # per layer: attention 1536*64*(2*24 + 2*8) = 6,291,456; router
    # 1536*40 = 61,440; one expert 3*1536*512 = 2,359,296
    active = 32 * (6_291_456 + 61_440 + 8 * 2_359_296) + 49_155 * 1_536
    assert active == 882_774_528
    flops = 2 * 1024 * active + 4 * 1024 * 32 * 24 * 64 * 100
    weights = 32 * ((6_291_456 + 61_440 + 40 * 2_359_296) * 2
                    + 2 * 1536 * 4) + 49_155 * 1536 * 2 + 1536 * 4
    kv = 1024 * (2 * 32 * 8 * 64 * 2) * 100
    logits = 1024 * 49_155 * 2
    got = moe.decode_step(_port("granite-moe-3b-a800m"), 1024, 100)
    assert got == {"flops": flops, "bytes": weights + kv + logits}
    assert got == {"flops": 1_828_054_892_544, "bytes": 13_409_342_464}


def test_zamba2_decode_step_by_hand():
    # a Mamba2 block: in_proj 2048*(2*4096 + 2*64 + 64), out_proj 4096*2048
    mamba = 2048 * 8384 + 4096 * 2048
    # the shared block: 32 heads of 128 over the 2,048-wide stream; it runs
    # 7 times
    shared = 4 * 2048 * 4096 + 3 * 2048 * 8192
    per_token = 2 * (38 * mamba + 7 * shared + 32_000 * 2048) \
        + 38 * (2 * 4 * 4224 + 5 * 64 * 64 * 64) + 7 * 4 * 32 * 128 * 200
    weights = 38 * (mamba * 2 + (4 * 4224 + 3 * 64 + 2048 + 4096) * 4) \
        + shared * 2 + 2 * 2048 * 4 + 2 * 32_000 * 2048 * 2 + 2048 * 4
    per_seq = 38 * (2 * 64 * 64 * 64 * 4 + 2 * 3 * 4224 * 2) \
        + 7 * 2 * 32 * 128 * 2 * 200 + 32_000 * 2
    got = hybrid.decode_step(_port("zamba2-1.2b"), 512, 200)
    assert got == {"flops": 512 * per_token,
                   "bytes": weights + 512 * per_seq}
    assert got == {"flops": 1_700_860_526_592, "bytes": 55_941_153_280}


def _param_bytes(name):
    from perfbench.run import build_config
    from repro_torch.models import model_class

    data = json.loads((ROOT / "perfbench" / "configs" / f"{name}.json")
                      .read_text())
    arch = build_config(data)
    model = model_class(arch)(arch, device="meta")
    return sum(p.numel() * p.element_size() for p in model.parameters())


def test_weight_bytes_are_the_ports_parameters():
    # granite's table is padded to 49,280 rows; the 125 padding rows are
    # not needed
    assert moe.weight_bytes(_port("granite-moe-3b-a800m")) \
        == _param_bytes("granite-moe-3b-a800m") - 125 * 1536 * 2
    assert hybrid.weight_bytes(_port("zamba2-1.2b")) \
        == _param_bytes("zamba2-1.2b")
