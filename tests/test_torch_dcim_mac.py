"""The torch port's ``dcim_mac`` (``repro_torch.kernels.dcim_mac``) against
the JAX package's Pallas kernels in interpret mode and its bit-serial DCIM
reference, on the CPU.

Tolerances, as the JAX package's own kernel tests state them
(``tests/test_kernels.py``): int32 outputs **exact**; the float32 dequant
epilogue within rtol 1e-6 (the port computes the same two f32 products in
the same order, so it is in fact exact); bfloat16 within rtol 1e-2.

On the CPU the wrappers run the plain versions; the CUDA kernel is held
against them on the card by ``tests/test_torch_cuda.py`` and by
``chip_smoke.py``.  Operands come from numpy seeds and reach both packages
as the same arrays.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels.dcim_mac import (dcim_matmul_int_pallas,
                                    dcim_matmul_int_pipelined_pallas,
                                    dcim_matmul_pallas,
                                    dcim_matmul_pipelined_pallas)
from repro.kernels.dcim_mac import ref as jref

from repro_torch.convert import mac_operands_from_numpy
from repro_torch.kernels import DEFAULT_TILES, TileConfig
from repro_torch.kernels.dcim_mac import (dcim_mac_cuda, dcim_mac_int_cuda,
                                          dcim_matmul, dcim_matmul_int,
                                          mac_plan, mac_route, ref)
from repro_torch.kernels.dcim_mac import plan
from repro_torch.obs.metrics import get_registry

# the shapes of the JAX package's kernel tests: padded, one block,
# multi-block, ragged, a single row
MAC_SHAPES = [(8, 16, 8), (128, 128, 128), (128, 256, 384), (130, 96, 200),
              (1, 512, 64)]

# the six qwen3-4b weight GEMMs at seq 256 (``gemm_inventory``), and the
# ragged shapes ``chip_smoke.py`` checks
QWEN_GEMMS = [(256, 2560, 4096), (256, 2560, 1024), (256, 2560, 1024),
              (256, 4096, 2560), (256, 2560, 19456), (256, 9728, 2560)]
RAGGED = [(8, 16, 8), (130, 96, 200), (1, 512, 64)]


def operands(m, k, n, seed, lo=-128, hi=127):
    rng = np.random.default_rng(seed)
    return (rng.integers(lo, hi + 1, (m, k), dtype=np.int8),
            rng.integers(lo, hi + 1, (k, n), dtype=np.int8),
            rng.uniform(0.01, 2.0, m).astype(np.float32),
            rng.uniform(0.01, 2.0, n).astype(np.float32))


def port(a, w, asc, wsc):
    return mac_operands_from_numpy(a, w, asc, wsc, device="cpu")


class TestIntVsPallas:
    @pytest.mark.parametrize("m,k,n", MAC_SHAPES)
    def test_grid_kernel(self, m, k, n):
        a, w, _, _ = operands(m, k, n, seed=m * 7 + n)
        want = np.asarray(dcim_matmul_int_pallas(jnp.asarray(a),
                                                 jnp.asarray(w),
                                                 interpret=True))
        ta, tw, _, _ = port(a, w, np.ones(m, np.float32),
                            np.ones(n, np.float32))
        got = dcim_matmul_int(ta, tw)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("m,k,n", MAC_SHAPES)
    def test_pipelined_kernel_depth2(self, m, k, n):
        a, w, _, _ = operands(m, k, n, seed=m * 11 + k)
        want = np.asarray(dcim_matmul_int_pipelined_pallas(
            jnp.asarray(a), jnp.asarray(w), depth=2, interpret=True))
        got = ref.dcim_matmul_int_ref(torch.as_tensor(a), torch.as_tensor(w))
        np.testing.assert_array_equal(got.numpy(), want)


class TestDequantVsPallas:
    @pytest.mark.parametrize("m,k,n", [(64, 128, 80), (130, 96, 200)])
    @pytest.mark.parametrize("pipelined", [False, True])
    @pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
    def test_epilogue(self, m, k, n, pipelined, out_dtype):
        a, w, asc, wsc = operands(m, k, n, seed=m + k + n)
        jdt = jnp.float32 if out_dtype == "float32" else jnp.bfloat16
        fn = dcim_matmul_pipelined_pallas if pipelined else dcim_matmul_pallas
        kw = {"depth": 2} if pipelined else {}
        want = np.asarray(fn(jnp.asarray(a), jnp.asarray(w),
                             jnp.asarray(asc), jnp.asarray(wsc),
                             out_dtype=jdt, interpret=True, **kw), np.float32)
        got = dcim_matmul(*port(a, w, asc, wsc),
                          out_dtype=getattr(torch, out_dtype))
        assert got.dtype == getattr(torch, out_dtype)
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=1e-2 if out_dtype == "bfloat16"
                                   else 1e-6)

    def test_f32_epilogue_is_exact(self):
        """Same products, same order: the f32 result is the Pallas bits."""
        a, w, asc, wsc = operands(96, 160, 72, seed=3)
        want = np.asarray(dcim_matmul_pallas(
            jnp.asarray(a), jnp.asarray(w), jnp.asarray(asc),
            jnp.asarray(wsc), interpret=True))
        np.testing.assert_array_equal(
            dcim_matmul(*port(a, w, asc, wsc)).numpy(), want)

    @pytest.mark.parametrize("kind", ["scalar", "row", "col"])
    def test_scale_broadcast(self, kind):
        m, k, n = 40, 64, 24
        a, w, asc, wsc = operands(m, k, n, seed=9)
        a_s = 0.37 if kind in ("scalar", "col") else asc
        w_s = 1.5 if kind in ("scalar", "row") else wsc
        want = np.asarray(dcim_matmul_pallas(
            jnp.asarray(a), jnp.asarray(w), jnp.asarray(a_s, jnp.float32),
            jnp.asarray(w_s, jnp.float32), interpret=True))
        got = dcim_matmul(torch.as_tensor(a), torch.as_tensor(w),
                          a_s if np.isscalar(a_s) else torch.as_tensor(a_s),
                          w_s if np.isscalar(w_s) else torch.as_tensor(w_s))
        np.testing.assert_array_equal(got.numpy(), want)

    def test_square_scales_are_per_row_and_per_column(self):
        """M == N: the row scale must not be read as a column scale."""
        a, w, asc, wsc = operands(16, 32, 16, seed=4)
        got = dcim_matmul(*port(a, w, asc, wsc)).numpy()
        acc = a.astype(np.int64) @ w.astype(np.int64)
        want = acc.astype(np.float32) * (asc[:, None] * wsc[None, :])
        np.testing.assert_array_equal(got, want)


class TestBitSerial:
    @pytest.mark.parametrize("a_bits,w_bits", [(8, 8), (4, 4), (4, 8),
                                               (2, 8), (8, 4), (1, 8)])
    def test_bitserial_equals_int_and_reference(self, a_bits, w_bits):
        lo_a, hi_a = ref.quant_range(a_bits) if a_bits > 1 else (0, 1)
        lo_w, hi_w = ref.quant_range(w_bits)
        rng = np.random.default_rng(a_bits * 10 + w_bits)
        a = rng.integers(lo_a, hi_a + 1, (64, 96)).astype(np.int8)
        w = rng.integers(lo_w, hi_w + 1, (96, 72)).astype(np.int8)
        bits_a = max(a_bits, 2)
        got = ref.dcim_matmul_bitserial_ref(torch.as_tensor(a),
                                            torch.as_tensor(w), bits_a,
                                            w_bits)
        want = np.asarray(jref.dcim_matmul_bitserial_ref(
            jnp.asarray(a), jnp.asarray(w), bits_a, w_bits))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            got.numpy(),
            dcim_matmul_int(torch.as_tensor(a), torch.as_tensor(w)).numpy())


class TestWrappers:
    @pytest.mark.parametrize("m,k,n", [(8, 16, 8), (64, 128, 64)])
    def test_cpu_tensors_take_the_plain_version(self, m, k, n):
        a, w, asc, wsc = port(*operands(m, k, n, seed=1))
        before = (dict(dcim_matmul.launches), dict(dcim_matmul_int.launches))
        dcim_matmul_int(a, w)
        dcim_matmul(a, w, asc, wsc)
        assert (dcim_matmul.launches, dcim_matmul_int.launches) == before
        assert set(dcim_matmul.launches) == {"pipelined", "grid"}

    @pytest.mark.parametrize("tile_config", [
        None, TileConfig(bm=256, bn=128, bk=128), TileConfig(depth=2),
        TileConfig(bk=128, depth=3), DEFAULT_TILES["dcim_mac"], "auto"])
    def test_tile_config_from_the_hopper_space(self, tile_config):
        """None, the TMA kernel's block (given in full or in part) at each
        ring depth it is compiled for, and "auto" are taken; every one
        gives the same product."""
        a, w, asc, wsc = port(*operands(8, 16, 8, seed=2))
        np.testing.assert_array_equal(
            dcim_matmul_int(a, w, tile_config=tile_config).numpy(),
            ref.dcim_matmul_int_ref(a, w).numpy())
        np.testing.assert_array_equal(
            dcim_matmul(a, w, asc, wsc, tile_config=tile_config).numpy(),
            ref.dcim_matmul_ref(a, w, asc, wsc).numpy())

    @pytest.mark.parametrize("tile_config", [
        TileConfig(bm=32), TileConfig(bm=128, bn=128, bk=128),
        TileConfig(bm=64, bn=64, bk=128, depth=4), TileConfig(depth=1),
        TileConfig(depth=5)])
    def test_tile_config_outside_the_hopper_space_raises(self, tile_config):
        a, w, asc, wsc = port(*operands(8, 16, 8, seed=2))
        with pytest.raises(ValueError, match="Hopper"):
            dcim_matmul_int(a, w, tile_config=tile_config)
        with pytest.raises(ValueError, match="Hopper"):
            dcim_matmul(a, w, asc, wsc, tile_config=tile_config)

    def test_kernel_entry_refuses_cpu_tensors(self):
        a, w, asc, wsc = port(*operands(8, 16, 8, seed=3))
        with pytest.raises(ValueError, match="CUDA"):
            dcim_mac_int_cuda(a, w)
        with pytest.raises(ValueError, match="CUDA"):
            dcim_mac_cuda(a, w, asc, wsc, torch.float32)

    def test_bad_scale_shape(self):
        a, w, _, _ = port(*operands(8, 16, 8, seed=5))
        with pytest.raises(ValueError):
            dcim_matmul(a, w, torch.ones(3), 1.0)

    def test_operands_from_numpy(self):
        a, w, asc, wsc = port(*operands(8, 16, 12, seed=6))
        assert (a.dtype, w.dtype, asc.dtype, wsc.dtype) == \
            (torch.int8, torch.int8, torch.float32, torch.float32)
        assert a.shape == (8, 16) and wsc.shape == (12,)


def _routes(fn):
    """The ``kernel/dcim_mac/route/<route>`` counters ``fn()`` adds to."""
    reg = get_registry()
    names = [f"kernel/dcim_mac/route/{r}" for r in ("pipelined", "grid")]
    before = [reg.counter(c).value for c in names]
    fn()
    return {c.rsplit("/", 1)[1]: reg.counter(c).value - b
            for c, b in zip(names, before) if reg.counter(c).value != b}


class TestPlan:
    """``plan.mac_route`` and ``plan.mac_plan``: how a call is cut up on the
    card, held to their contract."""

    @pytest.mark.parametrize("m,k,n", QWEN_GEMMS)
    def test_qwen_gemms_take_the_tma_route(self, m, k, n):
        assert mac_route(m, k, n, 0, 4096) == "pipelined"

    @pytest.mark.parametrize("m,k,n", RAGGED)
    def test_ragged_shapes_take_the_grid_route(self, m, k, n):
        assert mac_route(m, k, n) == "grid"

    @pytest.mark.parametrize("a_off,w_off,want", [
        (1, 0, "grid"), (0, 8, "grid"), (16, 32, "pipelined")])
    def test_misaligned_operands_take_the_grid_route(self, a_off, w_off,
                                                     want):
        assert mac_route(256, 2560, 1024, 4096 + a_off, 4096 + w_off) == want

    def test_the_route_follows_the_tensors(self):
        """An A that starts one byte into its storage goes to the grid
        route, on the CPU as on the card, and the dispatch counters name
        the route."""
        a, w, _, _ = port(*operands(256, 256, 256, seed=7))
        a_off = torch.empty(a.numel() + 1, dtype=torch.int8)[1:].view(a.shape)
        a_off.copy_(a)
        assert _routes(lambda: dcim_matmul_int(a, w)) == {"pipelined": 1}
        assert _routes(lambda: dcim_matmul_int(a_off, w)) == {"grid": 1}
        np.testing.assert_array_equal(dcim_matmul_int(a_off, w).numpy(),
                                      ref.dcim_matmul_int_ref(a, w).numpy())

    @pytest.mark.parametrize("m,k,n", QWEN_GEMMS + [
        (1, 8, 8), (64, 128, 64), (130, 96, 208), (300, 640, 384),
        (512, 512, 512), (257, 129, 129), (1000, 4096, 16)])
    def test_strips_and_splits_cover_every_product_once(self, m, k, n):
        p = mac_plan(m, k, n)
        assert p.splits in plan.SLOTS and p.splits <= max(p.stages, 1)
        hits = np.zeros((m, n, k), np.int8) if m * n * k <= 2 ** 22 else None
        rows = np.zeros(m, np.int64)
        cols = np.zeros(n, np.int64)
        for y in range(p.m_strips):
            rows[y * plan.BM:(y + 1) * plan.BM] += 1
        for x in range(p.n_strips):
            cols[x * plan.BN:(x + 1) * plan.BN] += 1
        depth = np.zeros(k, np.int64)
        for kb, ke in p.k_ranges:
            depth[kb:ke] += 1
        assert (rows == 1).all() and (cols == 1).all() and (depth == 1).all()
        if hits is not None:
            for y in range(p.m_strips):
                for x in range(p.n_strips):
                    for kb, ke in p.k_ranges:
                        hits[y * plan.BM:(y + 1) * plan.BM,
                             x * plan.BN:(x + 1) * plan.BN, kb:ke] += 1
            assert (hits == 1).all()
        assert p.blocks == p.m_strips * p.n_strips * p.splits
        assert p.m_strips * plan.BM >= m > (p.m_strips - 1) * plan.BM
        assert p.n_strips * plan.BN >= n > (p.n_strips - 1) * plan.BN

    @pytest.mark.parametrize("m,k,n", QWEN_GEMMS + [(512, 512, 512),
                                                    (300, 1000, 384)])
    def test_split_ranges_are_whole_stages_but_the_last(self, m, k, n):
        p = mac_plan(m, k, n)
        ranges = p.k_ranges
        assert len(ranges) == p.splits
        assert ranges[0][0] == 0 and ranges[-1][1] == k
        for (b0, e0), (b1, _) in zip(ranges, ranges[1:]):
            assert e0 == b1 and b0 < e0
            assert b0 % plan.BK == 0 and (e0 - b0) % plan.BK == 0
        sizes = [e - b for b, e in p.stage_ranges]
        assert max(sizes) - min(sizes) <= 1

    def test_qwen_gemms_fill_the_card(self):
        """The K split the plan picks for each qwen3-4b GEMM (the times
        behind the cost model are in PERF.md): every split count, and no
        GEMM left on fewer than a third of the SMs."""
        splits = [mac_plan(*g).splits for g in QWEN_GEMMS]
        assert splits == [2, 8, 8, 4, 1, 4]
        for g in QWEN_GEMMS:
            assert mac_plan(*g).blocks >= plan.SLOTS[1] // 3

    @pytest.mark.parametrize("m,k,n", [(256, 2560, 1024), (256, 4096, 2560),
                                       (300, 1000, 384), (64, 384, 48)])
    def test_split_sums_wrap_to_the_plain_version(self, m, k, n):
        """The plain version over each planned K range, summed with int32
        wrap, is the plain version over K and the JAX package's
        reference, also where the int32 sums wrap."""
        a, w, _, _ = operands(m, k, n, seed=m + k)
        ta, tw = torch.as_tensor(a), torch.as_tensor(w)
        whole = ref.dcim_matmul_int_ref(ta, tw)
        total = torch.zeros((m, n), dtype=torch.int32)
        for kb, ke in mac_plan(m, k, n).k_ranges:
            total += ref.dcim_matmul_int_ref(ta[:, kb:ke], tw[kb:ke])
        assert torch.equal(total, whole)
        np.testing.assert_array_equal(
            total.numpy(), np.asarray(jref.dcim_matmul_int_ref(
                jnp.asarray(a), jnp.asarray(w))))

    @pytest.mark.parametrize("splits", [2, 4, 8])
    def test_wrapping_partials_sum_alike_in_any_order(self, splits):
        """What the cluster's reduction relies on: int32 partials near the
        extremes sum to the same bits (the int64 sum mod 2**32) in every
        order, so no order of the ranks changes the product."""
        rng = np.random.default_rng(splits)
        parts = rng.choice(np.array([2 ** 31 - 1, -2 ** 31, -1, 1, 7], np.int64),
                           (splits, 64))
        want = ((parts.sum(0) + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)
        t = torch.as_tensor(parts.astype(np.int32))
        for order in (range(splits), reversed(range(splits)),
                      rng.permutation(splits)):
            acc = torch.zeros(64, dtype=torch.int32)
            for q in order:
                acc += t[q]
            np.testing.assert_array_equal(acc.numpy(), want)
