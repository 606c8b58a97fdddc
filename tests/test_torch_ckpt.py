"""The torch port's checkpoints and restarts (``repro_torch.ckpt``), its
training launcher (``python -m repro_torch.launch.train``) and training
examples, against the JAX package's, on the CPU.

Checkpoints are in the JAX package's file format, so each package reads the
other's: the tests write with one and restore with the other, and hold the
arrays, shapes and dtypes equal (not the manifest's bytes: its ``treedef``
is the repr of a JAX treedef on one side, the port's JSON description of
the tree on the other).  The JAX package's own restore of a bfloat16 leaf
hands back 2-byte void records (ROADMAP.md, "Reference state"); a test
pins that and leaves it standing, while the port reads the same file bit
for bit.

The launchers run in subprocesses.  The two packages draw their parameters
from different generators, so both launchers resume from one step-0
checkpoint that the JAX package writes (its parameters from key 0 and
their fresh AdamW state): their printed losses and grad norms must then be
equal as printed (4 and 3 decimals), or, where the port's float32 sums
flip one fake-quant code against the reference's, within ``LAUNCH_TOL``
relative (the step test's ``FLIP_LOSS`` of ``tests/test_torch_train.py``).
"""

import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as JCheckpointManager
from repro.configs import smoke_config as jax_smoke_config
from repro.models import get_model as jax_get_model
from repro.optim import adamw_init as jax_adamw_init
from repro.parallel.logical import split_logical
from repro.parallel.sharding import MESH_RULES

from repro_torch.ckpt import (CheckpointManager, FailureInjector,
                              InjectedFailure, load_checkpoint,
                              run_with_restarts, save_checkpoint)
from repro_torch.ckpt.manager import _flatten
from repro_torch.configs import smoke_config
from repro_torch.convert import (train_state_from_numpy, train_state_layout,
                                 train_state_to_numpy)
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as launch

REPO = pathlib.Path(__file__).resolve().parents[1]
# subprocesses on one thread too (see ``one_thread``)
ENV = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
           OMP_NUM_THREADS="1")
LAUNCH_TOL = 1e-3


def jax_state(arch="llama3.2-3b", **replace):
    """The JAX package's (params, adamw_init(params)) at key 0."""
    cfg = jax_smoke_config(arch).replace(**replace)
    params, _ = split_logical(jax_get_model(cfg).init_params(
        jax.random.PRNGKey(0)), MESH_RULES)
    return cfg, (params, jax_adamw_init(params))


def as_numpy(x) -> np.ndarray:
    """A leaf as numpy, a bfloat16 one as its int16 bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.view(np.int16)
    return x


def dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return np.asarray(x).dtype.name


def assert_trees_equal(want, got) -> None:
    """Same leaves in jax.tree order: arrays (bits), shapes and dtypes."""
    a, b = jax.tree.leaves(want), _flatten(got)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert dtype_name(x) == dtype_name(y), (dtype_name(x), dtype_name(y))
        x, y = as_numpy(x), as_numpy(y)
        assert x.shape == y.shape
        assert x.tobytes() == y.tobytes()



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
# 1. the reference's checkpoint contracts (test_substrate.py) on the port
# ---------------------------------------------------------------------------


class TestCkpt:
    def test_save_restore_roundtrip(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=2)
        tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4)},
                "step": 3}
        mgr.save(3, tree)
        restored, step = mgr.restore(tree)
        assert step == 3
        np.testing.assert_array_equal(restored["a"], tree["a"].numpy())
        np.testing.assert_array_equal(restored["b"]["c"], np.ones(4))
        assert int(restored["step"]) == 3

    def test_keep_k_gc(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, {"x": torch.ones(2), "step": s})
        steps = sorted(int(p.name.split("_")[1])
                       for p in tmp_path.glob("step_*"))
        assert steps == [3, 4]

    def test_async_save_fence(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=3)
        mgr.async_save(1, {"x": torch.full((1000,), 7.0), "step": 1})
        assert mgr.wait(timeout=30)
        assert mgr.latest_step() == 1

    def test_restart_drill_exactly_once(self, tmp_path):
        """Injected failures at steps 7 and 13; the run must complete with
        the same final state as a failure-free run (deterministic data)."""
        def step_fn(step, state):
            state = dict(state)
            state["acc"] = state["acc"] + np.float64(step)
            return state

        mgr = CheckpointManager(tmp_path / "a", keep=3)
        mgr.save(0, {"acc": np.float64(0), "step": 0})
        out = run_with_restarts(step_fn, {"acc": np.float64(0), "step": 0},
                                20, mgr, save_every=5,
                                injector=FailureInjector(fail_at=(7, 13)))
        assert out["restarts"] == 2
        assert out["acc"] == sum(range(20))

    def test_atomicity_no_partial_dirs(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=3)
        mgr.save(1, {"x": torch.ones(3), "step": 1})
        for p in tmp_path.glob("step_*"):
            assert (p / "manifest.json").exists()
        assert not list(tmp_path.glob(".tmp_step_*"))

    def test_too_many_failures_raise(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=3)
        with pytest.raises(InjectedFailure):
            run_with_restarts(lambda step, st: dict(st), {"step": 0}, 5, mgr,
                              injector=FailureInjector(fail_at=(1, 2, 3)),
                              max_restarts=2)


class TestFormat:
    def test_layout_is_the_reference_one(self, tmp_path):
        tree = {"b": torch.ones(2, dtype=torch.bfloat16),
                "a": (np.arange(3, dtype=np.int32), [2.5, None]),
                "step": 7}
        path = save_checkpoint(tmp_path, 7, tree, host_id=3,
                               meta={"run": "x"})
        assert path == tmp_path / "step_00000007"
        assert sorted(p.name for p in path.iterdir()) == [
            "manifest.json", "shard_00003.npz"]
        man = json.loads((path / "manifest.json").read_text())
        assert man["step"] == 7 and man["n_leaves"] == 4
        assert man["meta"] == {"run": "x"}
        assert man["dtypes"] == ["int32", "float64", "bfloat16", "int64"]
        assert man["shapes"] == [[3], [], [2], []]
        data = np.load(path / "shard_00003.npz")
        assert sorted(data.files) == ["a0", "a1", "a2", "a3"]
        assert data["a2"].dtype == np.dtype("V2")
        assert json.loads(man["treedef"]) == {
            "a": {"tuple": ["*", {"list": ["*", None]}]}, "b": "*",
            "step": "*"}

    def test_leaves_flatten_in_jax_order(self):
        tree = {"z": [1, {"y": 2, "x": (3, None, 4)}], "a": {"c": 5, "b": 6},
                "m": None}
        assert _flatten(tree) == jax.tree.leaves(tree)

    def test_restore_keeps_the_given_structure(self, tmp_path):
        tree = {"p": {"w": torch.ones(2), "g": torch.zeros(3)},
                "opt": (torch.tensor(4, dtype=torch.int32), [torch.ones(1)])}
        save_checkpoint(tmp_path, 1, tree)
        got, step = load_checkpoint(tmp_path, {"p": {"w": 0, "g": 0},
                                               "opt": (0, [0])})
        assert step == 1 and isinstance(got["opt"], tuple)
        assert isinstance(got["opt"][1], list)
        np.testing.assert_array_equal(got["p"]["g"], np.zeros(3))
        assert got["opt"][0].dtype == np.int32 and int(got["opt"][0]) == 4

    def test_restore_rejects_another_tree(self, tmp_path):
        save_checkpoint(tmp_path, 1, {"a": torch.ones(2)})
        with pytest.raises(ValueError, match="leaves"):
            load_checkpoint(tmp_path, {"a": 0, "b": 0})

    def test_no_checkpoint_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            load_checkpoint(tmp_path, {"a": 0})
        assert CheckpointManager(tmp_path).latest_step() is None

    def test_async_save_snapshots_before_training_writes(self, tmp_path):
        # the step writes parameters in place: the checkpoint must hold
        # the values at the call
        w = torch.ones(1000)
        mgr = CheckpointManager(tmp_path, keep=2)
        mgr.async_save(1, {"w": w})
        w.mul_(3.0)
        assert mgr.wait(timeout=30)
        got, _ = mgr.restore({"w": 0})
        np.testing.assert_array_equal(got["w"], np.ones(1000))

    def test_bfloat16_round_trips_bit_for_bit(self, tmp_path):
        w = torch.randn(3, 5, generator=torch.Generator().manual_seed(1)
                        ).to(torch.bfloat16)
        save_checkpoint(tmp_path, 2, {"w": w})
        got, _ = load_checkpoint(tmp_path, {"w": 0})
        assert got["w"].dtype == torch.bfloat16
        assert torch.equal(got["w"].view(torch.int16), w.view(torch.int16))


# ---------------------------------------------------------------------------
# 2. cross-reading with the JAX package
# ---------------------------------------------------------------------------


class TestCrossRead:
    @pytest.mark.parametrize("arch", ("llama3.2-3b", "rwkv6-7b",
                                      "zamba2-1.2b"))
    def test_port_restores_the_reference_train_state(self, tmp_path, arch):
        _, state = jax_state(arch)
        JCheckpointManager(tmp_path).save(5, state)
        cfg = smoke_config(arch)
        tree, step = CheckpointManager(tmp_path).restore(
            train_state_layout(cfg))
        assert step == 5
        assert_trees_equal(state, tree)
        model, opt = train_state_from_numpy(cfg, tree, device="cpu")
        assert_trees_equal(state, train_state_to_numpy(cfg, model, opt))

    @pytest.mark.parametrize("arch", ("llama3.2-3b", "whisper-tiny",
                                      "granite-moe-1b-a400m"))
    def test_reference_restores_the_port_train_state(self, tmp_path, arch):
        _, state = jax_state(arch)
        cfg = smoke_config(arch)
        model, opt = train_state_from_numpy(cfg, jax.tree.map(np.asarray,
                                                              state),
                                            device="cpu")
        opt["count"] += 3
        for t in opt["m"].values():
            t.add_(0.25)
        mine = train_state_to_numpy(cfg, model, opt)
        CheckpointManager(tmp_path).save(3, mine)
        got, step = JCheckpointManager(tmp_path).restore(state)
        assert step == 3
        assert int(got[1]["count"]) == 3
        assert_trees_equal(got, mine)
        assert jax.tree.structure(got) == jax.tree.structure(state)

    def test_port_reads_the_reference_bfloat16_bit_for_bit(self, tmp_path):
        _, state = jax_state("qwen3-4b", param_dtype="bfloat16",
                             compute_dtype="bfloat16")
        JCheckpointManager(tmp_path).save(1, state)
        cfg = smoke_config("qwen3-4b").replace(param_dtype="bfloat16",
                                               compute_dtype="bfloat16")
        tree, _ = CheckpointManager(tmp_path).restore(train_state_layout(cfg))
        assert_trees_equal(state, tree)
        assert tree[0]["embed"]["emb"].dtype == torch.bfloat16
        model, opt = train_state_from_numpy(cfg, tree, device="cpu")
        assert model.embed.emb.dtype == torch.bfloat16
        assert_trees_equal(state, train_state_to_numpy(cfg, model, opt))

    def test_reference_reads_the_port_bfloat16_bits(self, tmp_path):
        w = torch.randn(4, 6, generator=torch.Generator().manual_seed(2)
                        ).to(torch.bfloat16)
        CheckpointManager(tmp_path).save(1, {"w": w, "s": 2})
        got, _ = JCheckpointManager(tmp_path).restore(
            {"w": jnp.zeros((4, 6), jnp.bfloat16), "s": 0})
        # the records are the port's bits; the JAX loader leaves them void
        assert got["w"].dtype == np.dtype("V2")
        np.testing.assert_array_equal(got["w"].view(np.int16),
                                      w.view(torch.int16).numpy())
        man = json.loads((tmp_path / "step_00000001" /
                          "manifest.json").read_text())
        assert man["dtypes"] == ["int64", "bfloat16"]

    def test_reference_bfloat16_restore_fault_stands(self, tmp_path):
        """ROADMAP.md, "Reference state": the JAX package restores a
        bfloat16 leaf as ``|V2`` records, which ``jnp.asarray`` refuses, so
        it cannot resume a bfloat16 run from its own checkpoint."""
        tree = {"w": jnp.ones((2, 3), jnp.bfloat16) * 1.5,
                "s": jnp.zeros((), jnp.int32)}
        mgr = JCheckpointManager(tmp_path)
        mgr.save(1, tree)
        got, _ = mgr.restore(tree)
        assert got["w"].dtype == np.dtype("V2")
        assert (got["w"].view(np.uint16) == 16320).all()      # 1.5's bits
        with pytest.raises(TypeError, match="V2"):
            jnp.asarray(got["w"])
        # the port restores the same file as bfloat16
        port, _ = CheckpointManager(tmp_path).restore({"w": 0, "s": 0})
        assert port["w"].dtype == torch.bfloat16
        assert torch.equal(port["w"], torch.full((2, 3), 1.5,
                                                 dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# 3. launchers and examples
# ---------------------------------------------------------------------------


def run(argv, timeout=300) -> list[str]:
    proc = subprocess.run(argv, capture_output=True, text=True, env=ENV,
                          cwd=REPO, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.splitlines()


STEP = re.compile(r"step +(\d+) loss=([-\d.]+) gnorm=([-\d.]+)")


def steps_of(lines) -> dict[int, tuple[str, str]]:
    return {int(m[1]): (m[2], m[3]) for m in map(STEP.match, lines) if m}


class TestLaunchers:
    def test_losses_follow_the_reference_launcher(self, tmp_path):
        # both launchers resume from one step-0 checkpoint of the JAX
        # package's initial state, then train steps 0..2
        _, state = jax_state()
        JCheckpointManager(tmp_path / "jax").save(0, state)
        shutil.copytree(tmp_path / "jax", tmp_path / "port")
        argv = ["--arch", "llama3.2-3b", "--smoke", "--steps", "3",
                "--batch", "4", "--seq", "16", "--save-every", "100"]
        ref = run([sys.executable, "-m", "repro.launch.train"] + argv
                  + ["--ckpt-dir", str(tmp_path / "jax")])
        port = run([sys.executable, "-m", "repro_torch.launch.train"] + argv
                   + ["--device", "cpu", "--ckpt-dir", str(tmp_path / "port")])
        assert "resumed from step 0" in ref and "resumed from step 0" in port
        want, got = steps_of(ref), steps_of(port)
        assert sorted(got) == sorted(want) == [0, 2]
        for step in want:
            if got[step] != want[step]:
                print(f"step {step}: {want[step]} / {got[step]}")
                for a, b in zip(want[step], got[step]):
                    assert abs(float(a) - float(b)) <= LAUNCH_TOL * abs(
                        float(a)) + 1e-4
        assert port[0].startswith("mesh {'data': 1, 'model': 1} | arch "
                                  "llama3.2-3b-smoke (~0.1M params, DCIM "
                                  "INT8xINT8)")
        assert port[-1].startswith("trained 3 steps in ")

    def test_resume_is_exactly_once(self, tmp_path):
        # a run saving at steps 2 and 4; the same run resumed from step 2
        # must print step 3's loss and grad norm exactly
        argv = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                "llama3.2-3b", "--smoke", "--steps", "4", "--batch", "4",
                "--seq", "16", "--save-every", "2", "--device", "cpu",
                "--ckpt-dir", str(tmp_path)]
        first = run(argv)
        assert sorted(p.name for p in tmp_path.glob("step_*")) == [
            "step_00000002", "step_00000004"]
        shutil.rmtree(tmp_path / "step_00000004")
        again = run(argv)
        assert "resumed from step 2" in again
        assert again[-1].startswith("trained 2 steps in ")
        assert steps_of(again)[3] == steps_of(first)[3]

    def test_save_every_then_resume(self, tmp_path):
        argv = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                "rwkv6-7b", "--smoke", "--batch", "4", "--seq", "16",
                "--device", "cpu", "--ckpt-dir", str(tmp_path)]
        first = run(argv + ["--steps", "3", "--save-every", "2"])
        assert "resumed" not in "\n".join(first)
        again = run(argv + ["--steps", "4"])
        assert "resumed from step 2" in again
        assert sorted(steps_of(again)) == [3]
        loss, gnorm = steps_of(again)[3]
        assert np.isfinite(float(loss)) and np.isfinite(float(gnorm))

    def test_mesh_rule(self, monkeypatch):
        assert serve_launch.make_host_mesh((4, 2)) == {
            "data": 1, "model": 1}
        # a mesh of more than one rank needs a process group that it fills
        # (tests/test_torch_scaleout.py runs the launcher over ranks)
        from repro_torch.launch import mesh
        monkeypatch.setattr(mesh, "world_size", lambda: 4)
        with pytest.raises(ValueError, match="process group holds 4"):
            serve_launch.make_host_mesh((1, 2))

    def test_mesh_wider_than_the_cpu_shrinks(self, capsys, tmp_path):
        launch.main(["--arch", "llama3.2-3b", "--smoke", "--steps", "1",
                     "--batch", "2", "--seq", "8", "--mesh", "2x4",
                     "--device", "cpu", "--ckpt-dir", str(tmp_path)])
        out = capsys.readouterr().out
        assert out.startswith("mesh {'data': 1, 'model': 1}")

    def test_launcher_needs_the_card_or_cpu(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a card is visible")
        with pytest.raises(RuntimeError, match='device="cpu"'):
            launch.main(["--arch", "llama3.2-3b", "--smoke", "--steps", "1",
                         "--ckpt-dir", str(tmp_path)])

    def test_parser_keeps_the_reference_flags(self):
        flags = {a.dest for a in launch.build_parser()._actions}
        assert flags >= {"arch", "smoke", "mesh", "steps", "batch", "seq",
                         "lr", "microbatches", "tuned", "ckpt_dir",
                         "save_every", "host_id", "n_hosts", "device"}

    def test_fault_tolerance_drill_example(self):
        lines = run([sys.executable, str(REPO / "examples" /
                                         "torch_fault_tolerance_drill.py"),
                     "--device", "cpu"])
        assert lines[-1] == "exactly-once restart semantics: PASS"
        clean, faulty = lines[-3], lines[-2]
        assert clean.split(":")[1].split()[0] == faulty.split(":")[1].split()[0]
        assert "(restarts=2)" in faulty

    def test_train_example(self, tmp_path):
        ck = str(tmp_path / "ck")
        argv = [sys.executable, str(REPO / "examples" /
                                    "torch_train_lm_dcim.py"),
                "--device", "cpu", "--ckpt-dir", ck, "--save-every", "3"]
        first = run(argv + ["--steps", "3"])
        assert first[0].startswith("model tiny-dcim-lm:")
        assert first[-1].startswith("done: 3 steps")
        again = run(argv + ["--steps", "4", "--resume"])
        assert "resumed from step 3" in again
