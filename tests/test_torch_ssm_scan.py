"""The torch port's ``ssm_scan`` (``repro_torch.kernels.ssm_scan``) against
the JAX package's sequential oracle, its associative oracle and its Pallas
kernels in interpret mode, on the CPU.

Tolerances, as the JAX package's own kernel tests state them
(``tests/test_kernels.py``): rtol/atol 2e-5 against the sequential
reference on the fixed shapes, 3e-5 on the ragged random ones.  The
Pallas kernels scan each chunk by log-depth doubling, the port's
sequential plain version (which the CUDA kernel computes bit for bit) and
the associative one in other orders, so float32 rounding differs by a few
ulp; the tolerances bound that.  The chunked plain version
(``ssm_scan_chunked_ref``, which the CUDA kernel computes bit for bit) is
held to the same tolerances at several chunk counts, and its split
(``ssm_chunks``) to its contract.  The CUDA kernel is held against the
plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.kernels.ssm_scan import ref as jax_scan
from repro.kernels.ssm_scan import (ssm_scan_pallas,
                                    ssm_scan_pipelined_pallas)

from repro_torch.convert import ssm_operands_from_numpy
from repro_torch.kernels import TileConfig, autotune
from repro_torch.kernels.ssm_scan import (ssm_chunks, ssm_scan,
                                          ssm_scan_assoc_ref,
                                          ssm_scan_chunked_ref, ssm_scan_cuda,
                                          ssm_scan_ref)
from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
from repro_torch.kernels.ssm_scan.ref import (SSM_MIN_CHUNK_ROWS,
                                              SSM_PARALLEL_COLUMNS)
from repro_torch.obs.metrics import get_registry

# the JAX package's kernel-test shapes: padded T and D at the 64-blocks
# below, one exact block, a single step
SCAN_SHAPES = [(16, 8), (128, 128), (130, 64), (257, 130), (512, 256),
               (1, 32)]
# ragged random shapes with decay anywhere in [0, 1), as the JAX package's
# property test draws them
RAGGED = [(1, 1), (7, 3), (33, 40), (80, 17), (61, 29)]

jax_ssm_scan_ref = jax.jit(jax_scan.ssm_scan_ref)
jax_assoc_ref = jax.jit(jax_scan.ssm_scan_assoc_ref)


def inputs(t, d, seed, lo=0.7):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, 1.0, (t, d)).astype(np.float32),
            rng.normal(size=(t, d)).astype(np.float32),
            rng.normal(size=(d,)).astype(np.float32))


def port(a, b, h0):
    return ssm_operands_from_numpy(a, b, h0, device="cpu")


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.fixture(autouse=True)
def _fresh_memo():
    autotune.clear_memo()
    autotune.set_registry(None)
    yield
    autotune.clear_memo()
    autotune.set_registry(None)


class TestPlainVersions:
    @pytest.mark.parametrize("t,d", SCAN_SHAPES)
    def test_sequential_equals_jax_sequential(self, t, d):
        a, b, h0 = inputs(t, d, seed=t * 31 + d)
        s, f = ssm_scan_ref(*port(a, b, h0))
        s_j, f_j = jax_ssm_scan_ref(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(h0))
        assert s.shape == (t, d) and f.shape == (d,)
        close(s, s_j, 2e-5)
        close(f, f_j, 2e-5)

    @pytest.mark.parametrize("t,d", SCAN_SHAPES + [(300, 96)])
    def test_assoc_equals_jax_assoc_and_sequential(self, t, d):
        a, b, h0 = inputs(t, d, seed=t + d, lo=0.5)
        s, f = ssm_scan_assoc_ref(*port(a, b, h0))
        s_j, f_j = jax_assoc_ref(jnp.asarray(a), jnp.asarray(b),
                                 jnp.asarray(h0))
        close(s, s_j, 2e-5)
        close(f, f_j, 2e-5)
        s_seq, f_seq = ssm_scan_ref(*port(a, b, h0))
        close(s, s_seq, 2e-5)
        close(f, f_seq, 2e-5)

    def test_identity_decay_is_cumsum(self):
        a, b, h0 = inputs(100, 16, seed=5)
        s, _ = ssm_scan_ref(*port(np.ones_like(a), b, np.zeros_like(h0)))
        close(s, np.cumsum(b, 0, dtype=np.float64), 1e-4)

    def test_empty_sequence_keeps_h0(self):
        a, b, h0 = inputs(0, 4, seed=6)
        for fn in (ssm_scan_ref, ssm_scan_assoc_ref, ssm_scan):
            s, f = fn(*port(a, b, h0))
            assert s.shape == (0, 4)
            np.testing.assert_array_equal(f.numpy(), h0)


class TestChunkedPlainVersion:
    """The chunked scan the card runs, against the JAX package's sequential
    oracle and Pallas kernel, at several chunk counts."""

    @pytest.mark.parametrize("t,d", SCAN_SHAPES + [(1000, 300), (1024, 256)])
    @pytest.mark.parametrize("chunks", [1, 2, 5, 64, "split"])
    def test_within_tolerance_of_jax(self, t, d, chunks):
        a, b, h0 = inputs(t, d, seed=t * 13 + d)
        chunks = ssm_chunks(t, d)[0] if chunks == "split" else chunks
        s, f = ssm_scan_chunked_ref(*port(a, b, h0), chunks)
        assert s.shape == (t, d) and f.shape == (d,)
        np.testing.assert_array_equal(f.numpy(), s[-1].numpy())
        s_j, f_j = jax_ssm_scan_ref(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(h0))
        close(s, s_j, 2e-5)
        close(f, f_j, 2e-5)
        if t <= 512:
            s_p, f_p = ssm_scan_pallas(jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(h0), bt=64, bd=64,
                                       interpret=True)
            close(s, s_p, 2e-5)
            close(f, f_p, 2e-5)

    @pytest.mark.parametrize("t,d", RAGGED)
    @pytest.mark.parametrize("chunks", [2, 3, "split"])
    def test_ragged_random(self, t, d, chunks):
        a, b, h0 = inputs(t, d, seed=t * 999 + d, lo=0.0)
        chunks = ssm_chunks(t, d)[0] if chunks == "split" else chunks
        s, f = ssm_scan_chunked_ref(*port(a, b, h0), chunks)
        s_j, f_j = jax_ssm_scan_ref(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(h0))
        close(s, s_j, 3e-5)
        close(f, f_j, 3e-5)

    @pytest.mark.parametrize("t,d", SCAN_SHAPES)
    def test_one_chunk_is_the_sequential_scan(self, t, d):
        a, b, h0 = port(*inputs(t, d, seed=t + 7 * d))
        s, f = ssm_scan_chunked_ref(a, b, h0, 1)
        s_seq, f_seq = ssm_scan_ref(a, b, h0)
        assert torch.equal(s, s_seq) and torch.equal(f, f_seq)

    def test_empty_sequence_keeps_h0(self):
        a, b, h0 = port(*inputs(0, 4, seed=6))
        s, f = ssm_scan_chunked_ref(a, b, h0, 3)
        assert s.shape == (0, 4) and torch.equal(f, h0)


class TestChunkSplit:
    """``ssm_chunks``: (S, L) from (T, D) alone."""

    @pytest.mark.parametrize("t,d", SCAN_SHAPES + RAGGED + [
        (1024, 256), (4096, 256), (1000, 300), (1024, 262_144),
        (524_288, 64), (1, 1), (17, 1)])
    def test_chunks_cover_t(self, t, d):
        s, rows = ssm_chunks(t, d)
        assert s >= 1 and rows >= 1
        assert (s - 1) * rows < t <= s * rows
        assert s <= 65_535
        # the plain version, given S, derives the same chunk length
        assert -(-t // s) == rows

    @pytest.mark.parametrize("t", [1, 1024, 4096])
    def test_wide_state_runs_one_pass(self, t):
        assert ssm_chunks(t, 262_144) == (1, t)
        assert ssm_chunks(t, SSM_PARALLEL_COLUMNS)[0] == 1

    @pytest.mark.parametrize("t,d", [(1024, 256), (4096, 256), (1000, 300)])
    def test_narrow_state_is_cut(self, t, d):
        s, rows = ssm_chunks(t, d)
        assert s > 1 and rows >= SSM_MIN_CHUNK_ROWS
        # chunks no longer than it takes S x D to reach the target
        assert rows <= max(SSM_MIN_CHUNK_ROWS,
                           -(-t * d // SSM_PARALLEL_COLUMNS))

    def test_split_takes_the_shape_alone(self):
        """No tile, depth or card enters the split: it takes (T, D), and
        the kernel binding asks it with nothing else."""
        import inspect
        from repro_torch.kernels.ssm_scan import kernel
        assert list(inspect.signature(ssm_chunks).parameters) == ["t", "d"]
        assert "ssm_chunks(t_len, d)" in inspect.getsource(
            kernel.ssm_scan_cuda)


class TestAgainstPallas:
    @pytest.mark.parametrize("t,d", SCAN_SHAPES)
    def test_grid_kernel(self, t, d):
        a, b, h0 = inputs(t, d, seed=t * 7 + d)
        s_j, f_j = ssm_scan_pallas(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(h0), bt=64, bd=64,
                                   interpret=True)
        s, f = ssm_scan(*port(a, b, h0), tile_config=TileConfig(
            bt=64, bd=64, depth=1))
        close(s, s_j, 2e-5)
        close(f, f_j, 2e-5)
        # the final state is the last real row's, not a padded row's
        np.testing.assert_array_equal(f.numpy(), s[-1].numpy())

    @pytest.mark.parametrize("t,d", SCAN_SHAPES)
    @pytest.mark.parametrize("depth", [2, 4])
    def test_pipelined_kernel(self, t, d, depth):
        a, b, h0 = inputs(t, d, seed=t * 11 + d + depth)
        s_j, f_j = ssm_scan_pipelined_pallas(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0), bt=64, bd=64,
            depth=depth, interpret=True)
        s, f = ssm_scan(*port(a, b, h0), tile_config=TileConfig(
            bt=64, bd=64, depth=depth))
        close(s, s_j, 2e-5)
        close(f, f_j, 2e-5)

    @pytest.mark.parametrize("t,d", RAGGED)
    def test_ragged_random(self, t, d):
        a, b, h0 = inputs(t, d, seed=t * 1000 + d, lo=0.0)
        s_j, f_j = ssm_scan_pallas(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(h0), bt=32, bd=32,
                                   interpret=True)
        s, f = ssm_scan(*port(a, b, h0))
        close(s, s_j, 3e-5)
        close(f, f_j, 3e-5)


class TestEntryPoint:
    @staticmethod
    def kernel_counters():
        return {k: v for k, v in get_registry().as_dict().items()
                if k.startswith("kernel/ssm_scan/")}

    @pytest.mark.parametrize("tile_config,route,source", [
        (None, "pipelined", "default"),
        (TileConfig(bt=64, bd=128, depth=1), "grid", "explicit"),
        (TileConfig(bt=32, bd=64, depth=4), "pipelined", "explicit"),
        ("auto", "pipelined", "default"),
    ])
    def test_routing_and_counters(self, tile_config, route, source):
        a, b, h0 = inputs(40, 24, seed=9)
        before = self.kernel_counters()
        s, _ = ssm_scan(*port(a, b, h0), tile_config=tile_config)
        after = self.kernel_counters()
        assert {k: v - before.get(k, 0) for k, v in after.items()
                if v != before.get(k, 0)} == {
            "kernel/ssm_scan/dispatch": 1,
            f"kernel/ssm_scan/route/{route}": 1,
            f"kernel/ssm_scan/tile_source/{source}": 1}
        np.testing.assert_array_equal(s.numpy(),
                                      ssm_scan_ref(*port(a, b, h0))[0])

    def test_cpu_tensors_launch_nothing(self):
        before = dict(ssm_scan.launches)
        ssm_scan(*port(*inputs(20, 8, seed=1)))
        assert ssm_scan.launches == before

    def test_launches_are_the_launch_functions_count(self):
        assert ssm_scan.launches is ssm_kernel.LAUNCHES
        assert set(ssm_scan.launches) == {"grid", "pipelined"}

    @pytest.mark.parametrize("tc", [TileConfig(bt=128, bd=128, depth=4),
                                    TileConfig(bt=32, bd=100),
                                    TileConfig(bt=32, bd=64, depth=8)])
    def test_infeasible_tile_raises(self, tc):
        with pytest.raises(ValueError, match="Hopper"):
            ssm_scan(*port(*inputs(8, 8, seed=2)), tile_config=tc)

    def test_kernel_entry_refuses_cpu_tensors(self):
        with pytest.raises(ValueError, match="CUDA"):
            ssm_scan_cuda(*port(*inputs(8, 8, seed=3)))

    def test_operands_from_numpy(self):
        a, b, h0 = ssm_operands_from_numpy(np.ones((2, 3)), np.zeros((2, 3)),
                                           np.ones(3), device="cpu")
        assert all(t.dtype == torch.float32 and t.is_contiguous()
                   for t in (a, b, h0))
