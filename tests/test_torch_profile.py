"""The port's kernel profiler (``repro_torch.kernels.profile``), the plain
versions of its skeletons and ``scripts/torch_profile_kernels.py``, against
the JAX package's on the CPU.

* every skeleton's plain version (its data token) against the JAX
  skeleton in interpret mode where that is defined (``csa_tree`` copy at
  bh 128, ``ssm_scan`` copy at bt 32), and against a direct numpy
  computation otherwise (``dcim_mac`` copy and compute, ``ssm_scan``
  compute, whose JAX skeletons read buffers that nothing filled): **exact**;
* the float32 / bfloat16 ``dcim_mac`` skeletons' plain versions (the int32
  token through the dequant epilogue): the epilogue against the JAX
  skeletons in interpret mode, each f32/bf16 JAX skeleton being its int32
  one's token through it, and the plain versions against numpy: **exact**;
* ``_traffic``, ``KernelProfile`` (``as_dict``, ``bound``,
  ``roofline_fraction``) and ``fraction_from_profiles`` against the JAX
  ones on the same fields: **equal**;
* the ``syndcim-kernel-profile/v1`` artifact **byte-identical** to the JAX
  package's, and each package reading the other's;
* ``profile_kernel(device="cpu")`` and the script at the smoke shapes.

The skeletons' CUDA kernels are held against these plain versions on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Inputs come from
numpy seeds.
"""

import importlib.util
import json
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import profile as jax_profile
from repro.kernels import tiles as jax_tiles
from repro.kernels.csa_tree.kernel import csa_tree_tiled_pallas
from repro.kernels.dcim_mac.kernel import (dcim_matmul_int_pipelined_pallas,
                                           dcim_matmul_pipelined_pallas)
from repro.kernels.ssm_scan.kernel import ssm_scan_pipelined_pallas

from repro_torch.kernels import profile
from repro_torch.kernels.build import SKELETONS, library_path
from repro_torch.kernels.csa_tree import kernel as csa_kernel
from repro_torch.kernels.csa_tree.ref import csa_tree_copy_ref
from repro_torch.kernels.dcim_mac import kernel as mac_kernel
from repro_torch.kernels.dcim_mac import mac_plan, ref as mac_ref
from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
from repro_torch.kernels.ssm_scan.ref import (ssm_chunks,
                                              ssm_scan_compute_ref,
                                              ssm_scan_copy_ref)
from repro_torch.kernels.tiles import DEFAULT_TILES, TileConfig

REPO = pathlib.Path(__file__).resolve().parents[1]


def _load_script(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the skeletons' tokens ---------------------------------------------------


class TestCsaTreeCopyToken:
    @pytest.mark.parametrize("h,n", [(600, 256), (128, 256), (1, 300),
                                     (257, 41)])
    def test_equals_jax_copy_skeleton(self, h, n):
        x = np.random.default_rng(h + n).integers(-2 ** 31, 2 ** 31 - 1,
                                                  (h, n), dtype=np.int32)
        want = np.asarray(csa_tree_tiled_pallas(
            jnp.asarray(x), bh=128, bn=256, interpret=True, _mode="copy"))
        got = csa_tree_copy_ref(torch.as_tensor(x), 128).numpy()
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("bh", [1, 32, 77, 128])
    def test_equals_numpy(self, bh):
        x = np.random.default_rng(bh).integers(-2 ** 31, 2 ** 31 - 1,
                                               (300, 50), dtype=np.int32)
        want = x[::bh].astype(np.int64).sum(0).astype(np.uint32)
        got = csa_tree_copy_ref(torch.as_tensor(x), bh).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want)


def _ssm_inputs(t, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.7, 1.0, (t, d)).astype(np.float32),
            rng.normal(size=(t, d)).astype(np.float32),
            rng.normal(size=(d,)).astype(np.float32))


class TestSsmScanTokens:
    # T a multiple of bt = 32, and not
    @pytest.mark.parametrize("t,d", [(64, 128), (96, 256), (100, 128),
                                     (45, 130)])
    def test_copy_equals_jax_copy_skeleton(self, t, d):
        a, b, h0 = _ssm_inputs(t, d, seed=t + d)
        want_s, want_f = ssm_scan_pipelined_pallas(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0), bt=32, bd=128,
            depth=2, interpret=True, _mode="copy")
        got_s, got_f = ssm_scan_copy_ref(torch.as_tensor(a),
                                         torch.as_tensor(b),
                                         torch.as_tensor(h0), 32)
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
        np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
        if t % 32:
            np.testing.assert_array_equal(got_f.numpy(), (a + b)[-1])
        else:
            np.testing.assert_array_equal(got_f.numpy(), h0)

    @staticmethod
    def numpy_compute_token(a, b, h0, chunks, bt):
        """Passes 1-3 of the chunked scan, one float32 multiply and one
        float32 add per step, each chunk's row r read from its row r mod
        min(bt, L)."""
        t = a.shape[0]
        rows = -(-t // chunks)
        s = -(-t // rows)
        sub = min(bt, rows)
        summaries = []
        for c in range(s - 1):
            prod = np.ones_like(h0)
            end = np.zeros_like(h0)
            for r in range(rows):
                av, bv = a[c * rows + r % sub], b[c * rows + r % sub]
                prod = np.float32(av * prod)
                end = np.float32(np.float32(av * end) + bv)
            summaries.append((prod, end))
        h = h0.copy()
        for prod, end in summaries:
            h = np.float32(np.float32(prod * h) + end)
        c = s - 1
        for r in range(t - c * rows):
            h = np.float32(np.float32(a[c * rows + r % sub] * h)
                           + b[c * rows + r % sub])
        return h

    @pytest.mark.parametrize("t,d,bt", [(1024, 256, 32), (1000, 300, 32),
                                        (100, 16384, 32), (257, 130, 64),
                                        (45, 8, 32), (1, 32, 32)])
    def test_compute_equals_numpy(self, t, d, bt):
        a, b, h0 = _ssm_inputs(t, d, seed=t * 7 + d)
        chunks = ssm_chunks(t, d)[0]
        states, got = ssm_scan_compute_ref(torch.as_tensor(a),
                                           torch.as_tensor(b),
                                           torch.as_tensor(h0), chunks, bt)
        assert states is None
        np.testing.assert_array_equal(
            got.numpy(), self.numpy_compute_token(a, b, h0, chunks, bt))


def _mac_inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-128, 128, (m, k), dtype=np.int8),
            rng.integers(-128, 128, (k, n), dtype=np.int8))


# the qwen3-4b wk GEMM (K split 8), a ragged M below one wgmma tile, a
# ragged M and N over a partial last stage, one token, M past one strip
MAC_SHAPES = [(256, 2560, 1024), (32, 128, 128), (130, 2000, 208),
              (1, 512, 64), (600, 640, 384)]


class TestDcimMacTokens:
    @pytest.mark.parametrize("m,k,n", MAC_SHAPES)
    def test_copy_equals_numpy(self, m, k, n):
        """Every output of strip (i, j) is the sum, over the K stages t, of
        the little-endian words of A[256 i, 128 t:128 t + 4] and W[128 t,
        128 j:128 j + 4], mod 2^32."""
        a, w = _mac_inputs(m, k, n, seed=m + k + n)
        want = np.zeros((m, n), np.uint32)
        for i in range(-(-m // 256)):
            for j in range(-(-n // 128)):
                tok = 0
                for t in range(-(-k // 128)):
                    tok += int(a[256 * i, 128 * t:128 * t + 4].view(
                        np.uint32)[0])
                    tok += int(w[128 * t, 128 * j:128 * j + 4].view(
                        np.uint32)[0])
                want[256 * i:256 * (i + 1), 128 * j:128 * (j + 1)] = \
                    tok & 0xFFFFFFFF
        got = mac_ref.dcim_mac_copy_ref(torch.as_tensor(a),
                                        torch.as_tensor(w)).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want)

    @pytest.mark.parametrize("m,k,n", MAC_SHAPES)
    def test_compute_equals_numpy(self, m, k, n):
        """Each K split's stages each add the product of the split's first
        stage, mod 2^32, with mac_plan's splits."""
        a, w = _mac_inputs(m, k, n, seed=m * 3 + k + n)
        plan = mac_plan(m, k, n)
        want = np.zeros((m, n), np.int64)
        for begin, end in plan.stage_ranges:
            k0 = 128 * begin
            first = (a[:, k0:k0 + 128].astype(np.int64)
                     @ w[k0:k0 + 128].astype(np.int64))
            for _ in range(begin, end):
                want += first
        got = mac_ref.dcim_mac_compute_ref(torch.as_tensor(a),
                                           torch.as_tensor(w)).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      (want & 0xFFFFFFFF).astype(np.uint32))

    def test_compute_depends_on_the_split(self):
        """wk's plan splits K eight ways: the token is not the K = 128
        product times the stage count."""
        a, w = _mac_inputs(256, 2560, 1024, seed=1)
        assert mac_plan(256, 2560, 1024).splits == 8
        got = mac_ref.dcim_mac_compute_ref(torch.as_tensor(a),
                                           torch.as_tensor(w))
        one = (a[:, :128].astype(np.int64) @ w[:128].astype(np.int64)) * 20
        assert not np.array_equal(got.numpy().astype(np.int64),
                                  one.astype(np.int32).astype(np.int64))


def _scales(m, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.01, 2.0, m).astype(np.float32),
            rng.uniform(0.01, 2.0, n).astype(np.float32))


SCALED = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _as_bits(x: np.ndarray) -> np.ndarray:
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)


class TestDcimMacScaledTokens:
    """K2: the float32 / bfloat16 skeletons of
    ``dcim_matmul_pipelined_pallas`` (its ``_mode``)."""

    @pytest.mark.parametrize("out_dtype", sorted(SCALED))
    @pytest.mark.parametrize("mode", ["copy", "compute"])
    @pytest.mark.parametrize("m,k,n", [(130, 512, 208), (64, 256, 128)])
    def test_jax_skeleton_is_the_int32_token_through_the_epilogue(
            self, m, k, n, mode, out_dtype):
        a, w = _mac_inputs(m, k, n, seed=m + n)
        asc, wsc = _scales(m, n, seed=k)
        jdt, tdt = SCALED[out_dtype]
        token = dcim_matmul_int_pipelined_pallas(
            jnp.asarray(a), jnp.asarray(w), interpret=True, _mode=mode)
        want = dcim_matmul_pipelined_pallas(
            jnp.asarray(a), jnp.asarray(w), jnp.asarray(asc),
            jnp.asarray(wsc), out_dtype=jdt, interpret=True, _mode=mode)
        got = mac_ref.dequant_epilogue(torch.as_tensor(np.asarray(token)),
                                       torch.as_tensor(asc),
                                       torch.as_tensor(wsc), tdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(
            got.view(torch.int16 if tdt == torch.bfloat16 else torch.int32)
            .numpy(), _as_bits(np.asarray(want)))

    @pytest.mark.parametrize("out_dtype", sorted(SCALED))
    @pytest.mark.parametrize("mode", ["copy", "compute"])
    @pytest.mark.parametrize("m,k,n", MAC_SHAPES)
    def test_plain_version_equals_numpy(self, m, k, n, mode, out_dtype):
        a, w = _mac_inputs(m, k, n, seed=m + k + n)
        asc, wsc = _scales(m, n, seed=m)
        _, tdt = SCALED[out_dtype]
        args = (torch.as_tensor(a), torch.as_tensor(w))
        token = {"copy": mac_ref.dcim_mac_copy_ref,
                 "compute": mac_ref.dcim_mac_compute_ref}[mode](*args)
        plain = {"copy": mac_ref.dcim_mac_copy_scaled_ref,
                 "compute": mac_ref.dcim_mac_compute_scaled_ref}[mode]
        got = plain(*args, torch.as_tensor(asc), torch.as_tensor(wsc), tdt)
        want = token.numpy().astype(np.float32) * (asc[:, None]
                                                   * wsc[None, :])
        assert got.dtype == tdt
        assert torch.equal(got, torch.as_tensor(want).to(tdt))


class TestBindings:
    """The bindings' ``_mode`` checks run before any device check, and the
    skeletons build as a library variant of their own."""

    def test_unknown_modes_raise(self):
        a = torch.zeros((64, 128), dtype=torch.int8)
        with pytest.raises(ValueError, match="_mode"):
            mac_kernel.dcim_mac_int_cuda(a, a.T.contiguous(), _mode="dma")
        with pytest.raises(ValueError, match="no compute skeleton"):
            csa_kernel.csa_tree_tiled_cuda(torch.zeros((8, 8), dtype=torch
                                                       .int32),
                                           _mode="compute")
        x = torch.zeros((8, 32))
        with pytest.raises(ValueError, match="_mode"):
            ssm_kernel.ssm_scan_cuda(x, x, x[0], _mode="dma")

    def test_unknown_mode_of_the_scaled_kernel_raises(self):
        a = torch.zeros((64, 128), dtype=torch.int8)
        s = torch.ones(64)
        with pytest.raises(ValueError, match="_mode"):
            mac_kernel.dcim_mac_cuda(a, a.T.contiguous(), s, s,
                                     torch.float32, _mode="dma")

    def test_skeleton_launches_count_by_mode_and_dtype(self):
        assert {mode: set(c) for mode, c in
                mac_kernel.SKELETON_LAUNCHES.items()} == {
            mode: {"int32", "float32", "bfloat16"}
            for mode in ("copy", "compute")}

    def test_skeleton_library_is_its_own_build(self):
        for name in ("dcim_mac", "ssm_scan"):
            main, skel = library_path(name), library_path(name, SKELETONS)
            assert main != skel and skel.name.startswith(f"lib{name}_"
                                                         f"{SKELETONS}-")
        with pytest.raises(ValueError, match="variant"):
            library_path("dcim_mac", "fast")

    def test_tma_kernel_mode_from_the_mangled_name(self):
        stem = "_ZN12_GLOBAL__N_13tma19dcim_mac_tma_kernelILi0ELi4ELi{}EEEvv"
        assert [mac_kernel.tma_kernel_mode(stem.format(m))
                for m in range(3)] == ["fused", "copy", "compute"]
        assert mac_kernel.tma_kernel_mode(
            "_ZN4grid20dcim_mac_grid_kernelILi0EEEvv") is None


# -- the profiler against the JAX package's -----------------------------------


TRAFFIC_CASES = [("dcim_mac", (256, 2560, 1024)), ("dcim_mac", (1, 8, 8)),
                 ("ssm_scan", (1024, 262_144)), ("ssm_scan", (1, 1)),
                 ("csa_tree", (2560, 262_144)), ("csa_tree", (600, 256))]


@pytest.mark.parametrize("kernel,shape", TRAFFIC_CASES)
def test_traffic_equals_jax(kernel, shape):
    assert profile._traffic(kernel, shape) == jax_profile._traffic(kernel,
                                                                   shape)


def test_traffic_unknown_kernel_raises():
    with pytest.raises(ValueError, match="unknown kernel"):
        profile._traffic("gemm", (1, 1, 1))


def test_schema_and_modes_equal_jax():
    assert profile.PROFILE_SCHEMA == jax_profile.PROFILE_SCHEMA
    assert profile.MODES == jax_profile.MODES


# (t_copy, t_compute, t_fused, compute_measured): bandwidth- and compute-
# bound, perfect overlap, a fused time of 0, a derived compute time
TIMES = [(30.0, 10.0, 40.0, True), (5.5, 12.25, 13.0, True),
         (7.0, 7.0, 7.0, True), (1.0, 2.0, 0.0, True),
         (80.0, 3.0, 82.5, False), (0.1, 3.0, 2.0, True)]


def _pair(kernel, shape, times, backend="cpu"):
    """The same profile point in both packages."""
    t_copy, t_compute, t_fused, measured = times
    tc = DEFAULT_TILES[kernel]
    nbytes, flops = profile._traffic(kernel, shape)
    fields = dict(kernel=kernel, shape=shape, t_copy_us=t_copy,
                  t_compute_us=t_compute, t_fused_us=t_fused,
                  bytes_moved=nbytes, flops=flops, compute_measured=measured)
    port = profile.KernelProfile(tile=tc, backend=backend, **fields)
    jax = jax_profile.KernelProfile(tile=jax_tiles.TileConfig(
        **{k: getattr(tc, k) for k in ("bm", "bn", "bk", "bt", "bd", "bh",
                                       "depth")}), **fields)
    return port, jax


def _profiles(backend="cpu"):
    return [_pair(kernel, shape, times, backend)
            for (kernel, shape), times in zip(TRAFFIC_CASES, TIMES)]


@pytest.mark.parametrize("i", range(len(TIMES)))
def test_kernel_profile_equals_jax(i):
    port, jax = _profiles()[i]
    assert port.as_dict() == jax.as_dict()
    assert port.bound == jax.bound
    assert port.roofline_fraction == jax.roofline_fraction


def test_fraction_from_profiles_equals_jax():
    pairs = _profiles()
    for k in range(len(pairs) + 1):
        ports, jaxs = [p for p, _ in pairs[:k]], [j for _, j in pairs[:k]]
        assert profile.fraction_from_profiles(ports) == \
            jax_profile.fraction_from_profiles(jaxs)
    assert profile.fraction_from_profiles([]) == 1.0


def _artifact_text(payload) -> str:
    return json.dumps(payload, indent=2, sort_keys=True) + "\n"


def test_payload_is_byte_identical_to_jax():
    pairs = _profiles()
    port = _artifact_text(profile.profiles_payload([p for p, _ in pairs]))
    jax = _artifact_text(jax_profile.profiles_payload([j for _, j in pairs]))
    assert port == jax
    assert json.loads(port)["backend"] == "cpu"


def test_payload_backend_is_where_the_profiles_ran():
    ports = [p for p, _ in _profiles("cuda")]
    assert profile.profiles_payload(ports)["backend"] == "cuda"
    assert profile.profiles_payload([])["backend"] is None
    mixed = ports[:1] + [p for p, _ in _profiles("cpu")][:1]
    with pytest.raises(ValueError, match="backends"):
        profile.profiles_payload(mixed)


class TestArtifactCrossReading:
    def test_jax_reads_the_ports_artifact(self, tmp_path):
        path = tmp_path / "port.json"
        payload = profile.profiles_payload([p for p, _ in _profiles()])
        path.write_text(_artifact_text(payload))
        assert jax_profile.load_profile_artifact(path) == payload
        assert jax_profile.fraction_from_profile_artifact(path) == \
            profile.fraction_from_profile_artifact(path) == \
            payload["fraction"]

    def test_port_reads_the_jax_artifact(self, tmp_path):
        path = tmp_path / "jax.json"
        payload = jax_profile.profiles_payload([j for _, j in _profiles()])
        path.write_text(_artifact_text(payload))
        assert profile.load_profile_artifact(path) == payload
        assert profile.fraction_from_profile_artifact(path) == \
            jax_profile.fraction_from_profile_artifact(path)

    def test_legacy_bare_list_upgrade(self, tmp_path):
        path = tmp_path / "legacy.json"
        path.write_text(json.dumps([p.as_dict() for p, _ in _profiles()]))
        assert profile.load_profile_artifact(path) == \
            jax_profile.load_profile_artifact(path)
        assert profile.load_profile_artifact(path)["backend"] is None
        empty = tmp_path / "empty.json"
        empty.write_text("[]")
        assert profile.load_profile_artifact(empty) == \
            jax_profile.load_profile_artifact(empty)

    @pytest.mark.parametrize("body", ['{"schema": "syndcim-kernel-tile/v1"}',
                                      '"profile"', "42"])
    def test_not_a_kernel_profile(self, tmp_path, body):
        path = tmp_path / "other.json"
        path.write_text(body)
        for mod in (profile, jax_profile):
            with pytest.raises(ValueError, match="not a kernel profile"):
                mod.load_profile_artifact(path)

    @pytest.mark.parametrize("fraction", [0.0, 1.5, -0.25])
    def test_fraction_out_of_range(self, tmp_path, fraction):
        path = tmp_path / "bad.json"
        path.write_text(json.dumps({"schema": profile.PROFILE_SCHEMA,
                                    "fraction": fraction, "profiles": []}))
        for mod in (profile, jax_profile):
            with pytest.raises(ValueError, match=r"\(0, 1\]"):
                mod.fraction_from_profile_artifact(path)

    def test_missing_file_is_an_error(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            profile.load_profile_artifact(tmp_path / "absent.json")


# -- profile_kernel and the script on the CPU ---------------------------------


SCRIPT = _load_script("scripts/torch_profile_kernels.py", "torch_profile")


def test_script_shapes_equal_the_jax_scripts():
    jax_script = _load_script("scripts/profile_kernels.py", "jax_profile_sh")
    assert SCRIPT.DEFAULT_SHAPES == jax_script.DEFAULT_SHAPES
    assert SCRIPT.SMOKE_SHAPES == jax_script.SMOKE_SHAPES


@pytest.mark.parametrize("kernel", sorted(SCRIPT.SMOKE_SHAPES))
def test_profile_kernel_on_the_cpu_at_the_smoke_shapes(kernel):
    (shape,) = SCRIPT.SMOKE_SHAPES[kernel]
    p = profile.profile_kernel(kernel, shape, iters=1, device="cpu")
    assert p.backend == "cpu" and p.shape == shape
    assert p.tile == DEFAULT_TILES[kernel]
    assert (p.bytes_moved, p.flops) == profile._traffic(kernel, shape)
    assert p.compute_measured == (kernel != "csa_tree")
    assert p.t_copy_us > 0 and p.t_fused_us > 0
    if kernel == "csa_tree":
        assert p.t_compute_us == max(p.t_fused_us - p.t_copy_us, 0.0)
    assert 0 < p.roofline_fraction <= 1


def test_profile_kernel_takes_a_tile():
    p = profile.profile_kernel("ssm_scan", (64, 32), iters=1, device="cpu",
                               tile_config=TileConfig(bt=64, bd=32, depth=1))
    assert p.tile == TileConfig(bt=64, bd=32, depth=1)


def test_dcim_mac_profile_needs_the_tma_kernel():
    with pytest.raises(ValueError, match="multiples of 16"):
        profile.profile_kernel("dcim_mac", (32, 100, 128), device="cpu")


def test_profile_kernel_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: device=None is valid here")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        profile.profile_kernel("csa_tree", (600, 256))


def test_script_end_to_end_on_the_cpu(tmp_path):
    out = tmp_path / "kp.json"
    res = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "torch_profile_kernels.py"),
         "--smoke", "--device", "cpu", "--iters", "1", "--json", str(out)],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[0].split() == ["kernel", "shape", "copy_us", "compute_us",
                                "fused_us", "bound", "roofline"]
    assert any(line.startswith("aggregate roofline fraction (geomean):")
               for line in lines)
    data = profile.load_profile_artifact(out)
    assert data["backend"] == "cpu"
    assert [p["kernel"] for p in data["profiles"]] == list(
        SCRIPT.SMOKE_SHAPES)
    assert out.read_text() == _artifact_text(data)
    assert jax_profile.fraction_from_profile_artifact(out) == \
        data["fraction"]
