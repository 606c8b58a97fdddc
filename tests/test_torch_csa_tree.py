"""The torch port's ``csa_tree`` (``repro_torch.kernels.csa_tree``) against
the JAX package's adder-tree kernels in interpret mode, its plain column
sum, and its reduction schedule level by level, on the CPU.

Tolerance: none.  The adder tree is integer arithmetic that wraps mod 2^32;
every output must equal the reference's bits.

Equality with the column sum holds for any correct carry-save schedule, so
it cannot show that the schedule was ported; ``TestSchedule`` does: the op
program the CUDA kernels run (``build_schedule``), executed in torch by
``reduce_levels``, gives the same lanes as the JAX package's
``_reduce_level`` at every level.  ``TestCodegen`` holds the straight-line
source generated for the register kernel to that program: its statements,
read back, are the program op for op (in stream order: ops that share a
slot keep their order) for every tile height of the tiled route and the
tall whole-stack heights, and a numpy ``uint32`` evaluator of those
statements equals the JAX package's kernels.  The CUDA kernels themselves are held against the
plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels.csa_tree import csa_tree_pallas, csa_tree_tiled_pallas
from repro.kernels.csa_tree import csa_tree_ref as jax_csa_tree_ref
from repro.kernels.csa_tree import kernel as jax_kernel

from repro_torch.convert import csa_operands_from_numpy
from repro_torch.kernels import TileConfig, autotune
from repro_torch.kernels.build import ptxas_report, source_library_path
from repro_torch.kernels.csa_tree import (CSA_MAX_ROWS, CSA_REG_ROWS,
                                          build_schedule, codegen,
                                          csa_tree_ref, csa_tree_rows_cuda,
                                          csa_tree_sum, csa_tree_tiled_cuda,
                                          reduce_lanes, reduce_levels)
from repro_torch.kernels.csa_tree import kernel as csa_kernel
from repro_torch.kernels.csa_tree.ref import ADD, FA, ZERO
from repro_torch.obs.metrics import get_registry

HEIGHTS = [1, 2, 3, 4, 5, 7, 64, 130, 600]
INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1


def stack(h, n=37, seed=0, extremes=False):
    rng = np.random.default_rng(seed + 1000 * h + n)
    if extremes:
        return rng.choice(np.array([INT32_MIN, INT32_MAX, -1, 0, 1],
                                   np.int32), (h, n))
    return rng.integers(-2 ** 16, 2 ** 16, (h, n), dtype=np.int32)


def wrapped_sum(x):
    s = x.astype(np.int64).sum(0) & 0xFFFFFFFF
    return np.where(s >= 2 ** 31, s - 2 ** 32, s).astype(np.int32)


def port(x):
    return csa_operands_from_numpy(x, device="cpu")


@pytest.fixture(autouse=True)
def _fresh_memo():
    autotune.clear_memo()
    autotune.set_registry(None)
    yield
    autotune.clear_memo()
    autotune.set_registry(None)


class TestPlainVersion:
    @pytest.mark.parametrize("h", HEIGHTS)
    @pytest.mark.parametrize("extremes", [False, True])
    def test_equals_jax_ref(self, h, extremes):
        x = stack(h, extremes=extremes)
        got = csa_tree_ref(port(x))
        assert got.dtype == torch.int32 and got.shape == (x.shape[1],)
        want = np.asarray(jax_csa_tree_ref(jnp.asarray(x)))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), wrapped_sum(x))

    def test_sum_wraps_mod_2_32(self):
        x = np.full((4, 3), INT32_MAX, np.int32)
        got = csa_tree_ref(port(x)).numpy()
        np.testing.assert_array_equal(got, np.full(3, -4, np.int32))

    @pytest.mark.parametrize("h", [h for h in HEIGHTS if h <= CSA_MAX_ROWS])
    @pytest.mark.parametrize("use_compressors", [True, False])
    @pytest.mark.parametrize("extremes", [False, True])
    def test_equals_whole_rows_pallas(self, h, use_compressors, extremes):
        x = stack(h, n=300, extremes=extremes)
        want = np.asarray(csa_tree_pallas(jnp.asarray(x),
                                          use_compressors=use_compressors,
                                          interpret=True))
        np.testing.assert_array_equal(csa_tree_ref(port(x)).numpy(), want)
        np.testing.assert_array_equal(
            reduce_lanes(port(x), use_compressors).numpy(), want)

    @pytest.mark.parametrize("h", HEIGHTS)
    @pytest.mark.parametrize("use_compressors", [True, False])
    def test_equals_tiled_pallas(self, h, use_compressors):
        x = stack(h, n=300, extremes=h % 2 == 1)
        want = np.asarray(csa_tree_tiled_pallas(
            jnp.asarray(x), use_compressors=use_compressors, bh=32,
            interpret=True))
        np.testing.assert_array_equal(
            csa_tree_sum(port(x), use_compressors=use_compressors).numpy(),
            want)


class TestSchedule:
    """The kernel's op program against the JAX package's schedule."""

    @staticmethod
    def jax_levels(x, use_compressors):
        """The lanes after every level of ``_reduce_lanes``' loop, from the
        JAX package's own ``_reduce_level`` (which runs on numpy rows)."""
        lanes = [x[i] for i in range(x.shape[0])]
        levels, guard = [], 0
        while len(lanes) > 2 and guard < 64:
            guard += 1
            reduced = jax_kernel._reduce_level(lanes, use_compressors)
            if len(reduced) >= len(lanes):
                reduced = [reduced[0] + reduced[1]] + reduced[2:]
            lanes = reduced
            levels.append(np.stack([np.asarray(v, np.int32)
                                    for v in lanes]))
        return levels

    @pytest.mark.parametrize("h", HEIGHTS)
    @pytest.mark.parametrize("use_compressors", [True, False])
    def test_level_by_level(self, h, use_compressors):
        x = stack(h, n=19, extremes=True)
        want = self.jax_levels(x, use_compressors)
        got = reduce_levels(port(x), use_compressors)
        assert [len(g) for g in got] == [len(w) for w in want]
        for level, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g.numpy(), w,
                                          err_msg=f"level {level}")

    @pytest.mark.parametrize("h", HEIGHTS)
    @pytest.mark.parametrize("use_compressors", [True, False])
    def test_program_fits_in_h_slots(self, h, use_compressors):
        s = build_schedule(h, use_compressors)
        assert s.ops.dtype == np.int32 and s.ops.shape[1] == 4
        if len(s.ops):
            assert s.ops[:, 1:3].min() >= 0 and s.ops[:, 1:].max() < h
            assert (s.ops[:, 3][s.ops[:, 0] != FA] == 0).all()
            assert set(s.ops[:, 3][s.ops[:, 3] < 0]) <= {ZERO}
        assert 0 <= s.result < h
        assert s.level_ends == tuple(sorted(s.level_ends))

    def test_compressors_chain_carry_out(self):
        """Eight rows: two compressors, the first with cin = 0, the second
        taking the first's carry-out; the last carry-out is appended."""
        s = build_schedule(8, True)
        assert s.ops[:4].tolist() == [[FA, 0, 1, 2], [FA, 0, 3, ZERO],
                                      [FA, 4, 5, 6], [FA, 4, 7, 1]]
        assert s.levels[0] == (0, 3, 4, 7, 5)

    def test_needs_a_row(self):
        with pytest.raises(ValueError, match="at least one row"):
            build_schedule(0)


def run_generated(text, x):
    """A numpy ``uint32`` evaluator of a generated register kernel: its
    statements, read back from ``text``, on each R-row tile of the (H, N)
    int32 stack ``x`` (rows past H read 0), the tile sums added into a
    32-bit accumulator, as ``csa_reg_kernel`` runs them."""
    loads, ops, result = codegen.read_back(text)
    rows = len(loads)
    h, n = x.shape
    words = np.zeros((-(-h // rows) * rows, n), np.uint32)
    words[:h] = x.view(np.uint32)
    acc = np.zeros(n, np.uint32)
    for tile in words.reshape(-1, rows, n):
        lane = {slot: tile[row].copy() for slot, row in zip(loads, loads)}
        for kind, a, b, c in ops.tolist():
            if kind == FA:
                u, v = lane[a], lane[b]
                w = np.zeros(n, np.uint32) if c == ZERO else lane[c]
                lane[a] = u ^ v ^ w
                lane[b] = ((u & v) | (v & w) | (u & w)) << np.uint32(1)
            else:
                assert kind == ADD
                lane[a] = u32_add(lane[a], lane[b])
        acc = u32_add(acc, lane[result])
    return acc.view(np.int32)


def u32_add(a, b):
    return ((a.astype(np.uint64) + b) & 0xFFFFFFFF).astype(np.uint32)


def mixed_stack(h, n, seed):
    """Random rows with the int32 extremes scattered through them."""
    x = stack(h, n, seed=seed)
    rng = np.random.default_rng(seed)
    pick = rng.random((h, n)) < 0.3
    x[pick] = rng.choice(np.array([INT32_MIN, INT32_MAX, -1, 0, 1],
                                  np.int32), int(pick.sum()))
    return x


def slot_sequences(ops):
    """For each slot, the ops that read or write it, in program order."""
    out = {}
    for op in ops.tolist():
        kind, x, y, z = op
        for slot in (x, y, z) if kind == FA and z != ZERO else (x, y):
            out.setdefault(slot, []).append(tuple(op))
    return out


def tree_lanes(text):
    """The most lanes a generated body holds at once: a lane is live from
    the first statement that reads it to the last (the result to the
    return)."""
    reads = []
    for line in text.splitlines():
        if m := codegen._FA.match(line):
            reads.append([int(v) for v in m.groups() if v])
        elif m := (codegen._ADD.match(line) or codegen._RESULT.match(line)):
            reads.append([int(v) for v in m.groups()])
    first, last = {}, {}
    for i, slots in enumerate(reads):
        for slot in slots:
            first.setdefault(slot, i)
            last[slot] = i
    return max(sum(first[s] <= i <= last[s] for s in first)
               for i in range(len(reads)))


TALL = [129, 200, 256, 300, 511, 512]


class TestCodegen:
    """The register kernel's generated source against the schedule and the
    JAX package's kernels."""

    @pytest.mark.parametrize("rows", list(range(1, CSA_REG_ROWS + 1)) + TALL)
    @pytest.mark.parametrize("use_compressors", [True, False])
    def test_statements_are_the_schedule(self, rows, use_compressors):
        """The statements are the schedule's ops, every row loaded once, in
        order, before its first reader: op for op in schedule order where
        the window is the whole stack, else each slot's in schedule
        order."""
        text = codegen.source(rows, use_compressors)
        loads, ops, result = codegen.read_back(text)
        sched = build_schedule(rows, use_compressors)
        assert loads == list(range(rows))
        if codegen.window(rows, use_compressors) == rows:
            np.testing.assert_array_equal(ops, sched.ops)
        assert len(ops) == len(sched.ops)
        assert slot_sequences(ops) == slot_sequences(sched.ops)
        assert result == sched.result
        assert f"constexpr int kRows = {rows};" in text
        assert "@" not in text

    @pytest.mark.parametrize("rows", [129, 256, 300, 400, CSA_MAX_ROWS])
    @pytest.mark.parametrize("use_compressors", [True, False])
    def test_window_is_the_largest_that_fits(self, rows, use_compressors):
        """The body holds at most ``TREE_LANES`` lanes, in the largest
        window that does; the schedule's own level order at 512 rows would
        hold more lanes than a thread has registers."""
        w = codegen.window(rows, use_compressors)
        assert tree_lanes(codegen.source(rows, use_compressors)) \
            <= codegen.TREE_LANES
        sched = build_schedule(rows, use_compressors)

        def lanes(window):
            return codegen.live_lanes(sched, codegen.window_order(sched,
                                                                  window))
        assert lanes(w) == tree_lanes(codegen.source(rows, use_compressors))
        for larger in (rows, *codegen.WINDOWS):
            if w < larger <= rows:
                assert lanes(larger) > codegen.TREE_LANES
        if rows == CSA_MAX_ROWS:
            assert lanes(rows) > 255

    @pytest.mark.parametrize("rows", [1, 2, 64, 77, CSA_REG_ROWS])
    @pytest.mark.parametrize("use_compressors", [True, False])
    def test_tiles_run_in_schedule_order(self, rows, use_compressors):
        """Up to ``CSA_REG_ROWS`` rows the window is the whole stack: every
        row loaded first, then the ops in the schedule's own order."""
        assert codegen.window(rows, use_compressors) == rows
        body = codegen.body(rows, use_compressors)
        lines = body.splitlines()
        assert all(codegen._LOAD.match(line) for line in lines[:rows])
        _, ops, _ = codegen.read_back(body)
        np.testing.assert_array_equal(
            ops, build_schedule(rows, use_compressors).ops)

    def test_read_back_refuses_a_read_before_its_load(self):
        body = codegen.body(8, True)
        load7 = "  uint32_t l7 = row<kRagged>(p, 7, n, rows_left);\n"
        assert body.count(load7) == 1
        moved = body.replace(load7, "").replace("  return",
                                                 load7 + "  return")
        with pytest.raises(ValueError, match="before their rows"):
            codegen.read_back(moved)

    @pytest.mark.parametrize("rows", [1, 2, 3, 5, 64, 77, 128])
    @pytest.mark.parametrize("use_compressors", [True, False])
    def test_evaluator_equals_whole_rows_pallas(self, rows, use_compressors):
        x = mixed_stack(rows, 67, seed=rows)
        want = np.asarray(csa_tree_pallas(jnp.asarray(x),
                                          use_compressors=use_compressors,
                                          interpret=True))
        got = run_generated(codegen.source(rows, use_compressors), x)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, wrapped_sum(x))

    @pytest.mark.parametrize("rows", TALL)
    @pytest.mark.parametrize("use_compressors", [True, False])
    def test_evaluator_equals_tall_whole_rows_pallas(self, rows,
                                                     use_compressors):
        """The tall kernels the rows route runs above ``CSA_REG_ROWS``."""
        x = mixed_stack(rows, 67, seed=rows)
        want = np.asarray(csa_tree_pallas(jnp.asarray(x),
                                          use_compressors=use_compressors,
                                          interpret=True))
        got = run_generated(codegen.source(rows, use_compressors), x)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, wrapped_sum(x))

    @pytest.mark.parametrize("bh", [32, 64, 128])
    @pytest.mark.parametrize("use_compressors", [True, False])
    def test_evaluator_equals_tiled_pallas(self, bh, use_compressors):
        x = mixed_stack(300, 41, seed=bh)
        want = np.asarray(csa_tree_tiled_pallas(
            jnp.asarray(x), use_compressors=use_compressors, bh=bh,
            interpret=True))
        got = run_generated(codegen.source(bh, use_compressors), x)
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("rows", [0, CSA_MAX_ROWS + 1])
    def test_rows_outside_registers_raise(self, rows):
        with pytest.raises(ValueError, match="registers"):
            codegen.source(rows)

    def test_library_keyed_on_text(self):
        a = codegen.source(64, True)
        b = codegen.source(64, False)
        name = codegen.library_name(64, True)
        assert name != codegen.library_name(64, False)
        assert source_library_path(name, a) == source_library_path(name, a)
        assert source_library_path(name, a) != source_library_path(name, b)
        assert source_library_path(name, a).parent.name == "kernels"

    def test_ptxas_report(self):
        log = "\n".join([
            "ptxas info    : 0 bytes gmem",
            "ptxas info    : Compiling entry function '_Z3fooPi' for "
            "'sm_90a'",
            "ptxas info    : Function properties for _Z3fooPi",
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
            "loads",
            "ptxas info    : Used 142 registers, used 0 barriers, 380 bytes "
            "cmem[0]",
            "ptxas info    : Compiling entry function '_Z3barPi' for "
            "'sm_90a'",
            "    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill "
            "loads",
            "ptxas info    : Used 255 registers"])
        assert ptxas_report(log) == {
            "_Z3fooPi": {"registers": 142, "spill_stores": 0,
                         "spill_loads": 0},
            "_Z3barPi": {"registers": 255, "spill_stores": 8,
                         "spill_loads": 4}}


class TestEntryPoint:
    @staticmethod
    def kernel_counters():
        return {k: v for k, v in get_registry().as_dict().items()
                if k.startswith("kernel/csa_tree/")}

    def delta(self, fn):
        before = self.kernel_counters()
        out = fn()
        after = self.kernel_counters()
        return out, {k: v - before.get(k, 0) for k, v in after.items()
                     if v != before.get(k, 0)}

    @pytest.mark.parametrize("h,tile_config,route,source", [
        (64, None, "rows", "default"),
        (CSA_MAX_ROWS, None, "rows", "default"),
        (CSA_MAX_ROWS + 1, None, "tiled", "default"),
        (64, TileConfig(bh=32, bn=128), "tiled", "explicit"),
        (64, "auto", "tiled", "default"),
    ])
    def test_routing_and_counters(self, h, tile_config, route, source):
        x = stack(h, n=50)
        out, d = self.delta(lambda: csa_tree_sum(port(x),
                                                 tile_config=tile_config))
        np.testing.assert_array_equal(out.numpy(), wrapped_sum(x))
        assert d == {"kernel/csa_tree/dispatch": 1,
                     f"kernel/csa_tree/route/{route}": 1,
                     f"kernel/csa_tree/tile_source/{source}": 1}

    def test_cpu_tensors_launch_nothing(self):
        before = dict(csa_tree_sum.launches)
        csa_tree_sum(port(stack(600)))
        assert csa_tree_sum.launches == before

    def test_launches_are_the_launch_functions_count(self):
        assert csa_tree_sum.launches is csa_kernel.LAUNCHES
        assert set(csa_tree_sum.launches) == {"rows", "tiled", "rows_tall"}

    @pytest.mark.parametrize("h,kernel", [
        (1, "rows"), (CSA_REG_ROWS, "rows"), (CSA_REG_ROWS + 1, "rows_tall"),
        (CSA_MAX_ROWS, "rows_tall")])
    def test_rows_route_kernel(self, h, kernel):
        assert csa_kernel.rows_kernel(h) == kernel

    def test_infeasible_tile_raises(self):
        with pytest.raises(ValueError, match="Hopper"):
            csa_tree_sum(port(stack(8)), tile_config=TileConfig(bh=256,
                                                                 bn=256))
        with pytest.raises(ValueError, match="auto"):
            csa_tree_sum(port(stack(8)), tile_config="fast")

    def test_kernel_entries_refuse_cpu_tensors(self):
        x = port(stack(8))
        for fn in (csa_tree_rows_cuda, csa_tree_tiled_cuda):
            with pytest.raises(ValueError, match="CUDA"):
                fn(x)

    def test_whole_rows_guard_raises(self):
        x = port(np.zeros((CSA_MAX_ROWS + 1, 8), np.int32))
        with pytest.raises(ValueError, match="csa_tree_tiled_cuda"):
            csa_tree_rows_cuda(x)

    def test_operands_from_numpy(self):
        x = csa_operands_from_numpy(np.arange(6, dtype=np.int64)
                                    .reshape(2, 3), device="cpu")
        assert x.dtype == torch.int32 and x.is_contiguous()
        with pytest.raises(ValueError, match="int32"):
            csa_operands_from_numpy(np.array([[2 ** 31]]), device="cpu")
