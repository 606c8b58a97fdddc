"""The torch port's serving launcher (``python -m repro_torch.launch.serve``)
and ``examples/torch_serve_decode.py``, on the CPU.

The JAX launcher's ``--dcim-select`` imports the reference engine, so it runs
in a subprocess with the ``enable_x64`` shim and the reference's
``roofline.hw.HBM_BW`` set to the port's (the H100's), as
``tests/test_torch_select.py`` does.  The port's launcher runs twice on one
frontier store, cold then warm, and must print the reference's selection
lines: the label, ``eff_tops``, ``util`` and the serving roofline.  The
model's tokens are not compared here: the two packages draw their parameters
from different generators (``tests/test_torch_models.py`` carries them
across instead).
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import serve as launch
from repro_torch.roofline import hw as port_hw

REPO = pathlib.Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
SELECT = ["--arch", "qwen3-4b", "--smoke", "--dcim-select", "--batch", "2",
          "--prompt-len", "8", "--decode-steps", "4"]

JAX_LAUNCHER = r"""
import sys
import jax, jax.experimental
jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
from repro.roofline import hw
hw.HBM_BW = float(sys.argv[1])
sys.argv = ["repro.launch.serve"] + sys.argv[2:]
from repro.launch.serve import main
main()
"""


def run(argv, timeout=300) -> list[str]:
    proc = subprocess.run(argv, capture_output=True, text=True, env=ENV,
                          cwd=REPO, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.splitlines()


def dcim_lines(lines, *prefixes) -> list[str]:
    return [ln for ln in lines if ln.startswith(prefixes)]


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    return tmp_path_factory.mktemp("launch")


@pytest.fixture(scope="module")
def launches(stores):
    """The JAX launcher once and the port's twice (cold, warm) on
    ``--dcim-select`` with a frontier store each."""
    ref = run([sys.executable, "-c", JAX_LAUNCHER, repr(port_hw.HBM_BW)]
              + SELECT + ["--dcim-cache", str(stores / "jax")])
    port = [run([sys.executable, "-m", "repro_torch.launch.serve"] + SELECT
                + ["--device", "cpu", "--dcim-cache", str(stores / "port")])
            for _ in range(2)]
    return ref, port


@pytest.mark.parametrize("arch", ("granite-moe-3b-a800m", "rwkv6-7b",
                                  "zamba2-1.2b"))
def test_each_family_selects_as_the_reference(arch, launches, stores):
    # the MoE, ssm and hybrid families' smoke configs from the stores the
    # qwen3-4b launches filled: warm in both packages, the same selection
    argv = ["--arch", arch] + SELECT[2:]
    ref = run([sys.executable, "-c", JAX_LAUNCHER, repr(port_hw.HBM_BW)]
              + argv + ["--dcim-cache", str(stores / "jax")])
    port = run([sys.executable, "-m", "repro_torch.launch.serve"] + argv
               + ["--device", "cpu", "--dcim-cache", str(stores / "port")])
    want = dcim_lines(ref, "dcim: selected", "dcim: serving roofline")
    assert len(want) == 2 and f" for {arch}-smoke " in want[0], ref
    assert dcim_lines(port, "dcim: selected",
                      "dcim: serving roofline") == want
    assert "warm (hits=4 misses=0 fused_passes=0" in "\n".join(port)
    assert f"arch={arch}-smoke" in "\n".join(port)


class TestSelectLaunch:
    def test_selection_equals_the_reference(self, launches):
        ref, (cold, warm) = launches
        want = dcim_lines(ref, "dcim: selected", "dcim: serving roofline",
                          "dcim: 15 frontier")
        assert len(want) == 3, ref
        for port in (cold, warm):
            assert dcim_lines(port, "dcim: selected",
                              "dcim: serving roofline",
                              "dcim: 15 frontier") == want
        assert "cloud/6T-oai22-csa_rho100_ro-fSO" in want[1]

    def test_cold_then_warm(self, launches):
        ref, (cold, warm) = launches
        assert "dcim: synthesis service cold (hits=0 misses=4 " \
               "fused_passes=1" in "\n".join(cold)
        assert "dcim: synthesis service warm (hits=4 misses=0 " \
               "fused_passes=0" in "\n".join(warm)
        # the reference's cold line, cache path aside
        assert dcim_lines(ref, "dcim: synthesis")[0].split(", cache=")[0] \
            == dcim_lines(cold, "dcim: synthesis")[0].split(", cache=")[0]

    def test_serving_lines(self, launches):
        _, (cold, _) = launches
        text = "\n".join(cold)
        assert "arch=qwen3-4b-smoke mesh={'data': 1, 'model': 1} " \
               "device=cpu" in text
        for head in ("init   : ", "prefill: 2x8 tokens in ",
                     "decode : 8 tokens in "):
            line = dcim_lines(cold, head)
            assert len(line) == 1 and line[0].endswith(" on cpu"), line
        sample = dcim_lines(cold, "sample:")[0]
        assert len(sample.split("[")[1].split()) == 4


@pytest.mark.parametrize("arch", ("qwen3-4b", "llama3.2-3b", "phi3-mini-3.8b",
                                  "mistral-large-123b", "internvl2-1b",
                                  "whisper-tiny", "granite-moe-1b-a400m",
                                  "granite-moe-3b-a800m", "rwkv6-7b",
                                  "zamba2-1.2b"))
def test_launch_each_smoke_config(arch, capsys):
    launch.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch",
                 "2", "--prompt-len", "6", "--decode-steps", "3"])
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke" in out
    assert "decode : 6 tokens in " in out


def test_trace_and_kernel_profile(tmp_path, capsys):
    profile = tmp_path / "kp.json"
    profile.write_text(json.dumps({"schema": "syndcim-kernel-profile/v1",
                                   "backend": "cpu", "fraction": 0.5,
                                   "profiles": []}))
    trace = tmp_path / "trace.json"
    launch.main(SELECT + ["--device", "cpu", "--dcim-trace", str(trace),
                          "--dcim-kernel-profile", str(profile)])
    out = capsys.readouterr().out
    assert "roofline derated by measured pipeline efficiency 0.500" in out
    assert "dcim: trace: " in out and trace.exists()
    events = json.loads(trace.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    assert any(e.get("name") == "engine.pass" for e in events)


def test_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        launch.main(["--arch", "qwen3-4b", "--smoke"])


class TestMesh:
    def test_parse_mesh(self):
        assert launch.parse_mesh("1x1") == ((1, 1), ("data", "model"))
        assert launch.parse_mesh("2x4x8") == ((2, 4, 8),
                                              ("pod", "data", "model"))

    def test_shrinks_to_the_device_count(self):
        # the reference's rule (launch/mesh.py): a mesh wider than the
        # visible devices becomes (1, ..., n_devices)
        assert launch.make_host_mesh((4, 4), n_devices=1) == \
            {"data": 1, "model": 1}
        assert launch.make_host_mesh((1, 1), n_devices=2) == \
            {"data": 1, "model": 1}

    @pytest.mark.parametrize("shape", ((1, 2), (2, 1), (4, 4)))
    def test_more_than_one_device_raises(self, shape):
        with pytest.raises(NotImplementedError, match="queue 1, item 8"):
            launch.make_host_mesh(shape, n_devices=2)

    def test_device_count(self):
        assert launch.device_count(torch.device("cpu")) == 1

    def test_mesh_flag_on_the_cpu_shrinks(self, capsys):
        launch.main(["--arch", "qwen3-4b", "--smoke", "--device", "cpu",
                     "--mesh", "2x2", "--batch", "1", "--prompt-len", "4",
                     "--decode-steps", "2"])
        assert "mesh={'data': 1, 'model': 1}" in capsys.readouterr().out


def test_serve_decode_example_on_the_cpu():
    lines = run([sys.executable, str(REPO / "examples" /
                                     "torch_serve_decode.py"),
                 "--device", "cpu", "--steps", "4", "--prompt-len", "8"])
    assert lines[0] == "arch=qwen3-4b-smoke family=dense"
    assert lines[1].endswith("tok/s on cpu)")
    assert lines[2].startswith("generated token ids (row 0): [")
