"""The port's kernel-support layer (``repro_torch.kernels.tiles``,
``autotune``, ``instrument`` and ``repro_torch.obs``) against the JAX
package's, on the CPU.

What carries over unchanged and is held equal: ``shape_class`` buckets,
``TileConfig`` payloads, the tile schema, and the dispatch counter names a
call records.  What is re-derived for Hopper and held to its own contract:
the tile space (shared-memory budget, warp alignment) and the backend
digest.  ``autotune(device="cpu")`` runs every candidate's plain version,
so only its plumbing is checked here; the card's winners are checked by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import csa_tree_sum as jax_csa_tree_sum
from repro.kernels import dcim_matmul_int as jax_dcim_matmul_int
from repro.kernels import ssm_scan as jax_ssm_scan
from repro.kernels import tiles as jax_tiles
from repro.kernels import autotune as jax_autotune
from repro.kernels.autotune import TILE_SCHEMA as JAX_TILE_SCHEMA
from repro.obs.metrics import get_registry as jax_get_registry

from repro_torch.kernels import (DEFAULT_TILES, TileConfig, autotune,
                                 csa_tree_sum, dcim_matmul_int, resolve_tile,
                                 shape_class, ssm_scan, tile_space)
from repro_torch.kernels.autotune import TILE_SCHEMA, tile_key
from repro_torch.kernels.tiles import (CSA_REG_ROWS, CSA_THREADS, KERNELS,
                                       MAC_DEPTHS, MAC_W_BUFS, MAX_THREADS,
                                       SMEM_BUDGET_BYTES, WARP, feasible,
                                       smem_bytes)
from repro_torch.obs import tracer
from repro_torch.obs.metrics import get_registry

SHAPES = {"dcim_mac": [(1, 8, 8), (100, 500, 512), (128, 512, 512),
                       (512, 512, 512), (33, 2560, 1024)],
          "ssm_scan": [(1, 32), (16, 8), (1024, 256), (4096, 256),
                       (1000, 300), (1024, 262_144)],
          "csa_tree": [(1, 5), (64, 262_144), (256, 512), (1024, 512),
                       (600, 300), (2560, 262_144)]}
CASES = [(k, s) for k, shapes in SHAPES.items() for s in shapes]


class FakeRegistry:
    """The duck-typed registry interface ``autotune`` publishes to."""

    def __init__(self):
        self.store, self.fetches = {}, 0

    def publish_payload(self, key, payload, schema):
        self.store[key] = (schema, dict(payload))

    def fetch_payload(self, key, schema):
        self.fetches += 1
        hit = self.store.get(key)
        return hit[1] if hit is not None and hit[0] == schema else None


@pytest.fixture(autouse=True)
def _fresh_memo():
    for tuner in (autotune, jax_autotune):
        tuner.clear_memo()
        tuner.set_registry(None)
    yield
    for tuner in (autotune, jax_autotune):
        tuner.clear_memo()
        tuner.set_registry(None)


class TestTiles:
    @pytest.mark.parametrize("kernel,shape", CASES + [
        ("ssm_scan", (400_000, 64)), ("ssm_scan", (524_288, 64))])
    def test_shape_class_equals_jax(self, kernel, shape):
        assert shape_class(kernel, shape) == \
            jax_tiles.shape_class(kernel, shape)

    @pytest.mark.parametrize("kernel,shape", CASES)
    def test_tile_space_is_feasible_on_hopper(self, kernel, shape):
        space = tile_space(kernel, shape)
        assert space and len(space) == len(set(space))
        for tc in space:
            assert feasible(kernel, tc)
            assert smem_bytes(kernel, tc) <= SMEM_BUDGET_BYTES
            threads = {"dcim_mac": 384, "ssm_scan": tc.bd,
                       "csa_tree": tc.bn}[kernel]
            assert threads % WARP == 0 and threads <= MAX_THREADS
            if kernel == "csa_tree":
                # the register kernel: its rows in registers, no shared
                # memory, blocks within its launch bound
                assert 1 <= tc.bh <= CSA_REG_ROWS
                assert threads <= CSA_THREADS
                assert smem_bytes(kernel, tc) == 0
        if DEFAULT_TILES[kernel] in space:
            assert space[0] == DEFAULT_TILES[kernel]

    @pytest.mark.parametrize("kernel,shape", [("ssm_scan", (1024, 256)),
                                              ("csa_tree", (256, 512))])
    def test_default_first_and_pruned_by_shared_memory(self, kernel, shape):
        space = tile_space(kernel, shape)
        assert space[0] == DEFAULT_TILES[kernel] and len(space) > 1
        lattice = {"ssm_scan": 4 * 4 * 3, "csa_tree": 4 * 4}[kernel]
        assert len(space) < lattice
        if kernel == "csa_tree":
            # pruned by the register cap, not by shared memory: every
            # 256-row tile goes, every tile of at most 128 rows stays
            assert {tc.bh for tc in space} == {32, 64, 128}
            assert len(space) == 3 * 4

    def test_small_shapes_prune_the_default(self):
        space = tile_space("ssm_scan", (16, 8))
        assert DEFAULT_TILES["ssm_scan"] not in space
        assert {tc.bd for tc in space} == {WARP}

    def test_dcim_mac_space_is_the_compiled_block(self):
        """The TMA kernel's one block at each ring depth it is compiled
        for, the default (four stages) first, every shape alike."""
        block = TileConfig(bm=256, bn=128, bk=128, depth=4)
        assert DEFAULT_TILES["dcim_mac"] == block
        for shape in SHAPES["dcim_mac"]:
            space = tile_space("dcim_mac", shape)
            assert space[0] == block
            assert [tc.depth for tc in space] == [4, 2, 3]
            assert {(tc.bm, tc.bn, tc.bk) for tc in space} == {(256, 128, 128)}

    @pytest.mark.parametrize("depth", MAC_DEPTHS)
    def test_dcim_mac_smem_is_the_kernels_count(self, depth):
        """What the kernel allocates: 1 KB alignment slack, ``depth`` A
        stages of 256 x 128 bytes, MAC_W_BUFS raw and as many transposed W
        stages of 128 x 128 bytes, two 8-byte mbarriers per stage of each
        ring; within the block's shared memory (the card test holds it
        against the kernel's own count)."""
        cfg = TileConfig(bm=256, bn=128, bk=128, depth=depth)
        want = (1024 + depth * 256 * 128 + 2 * MAC_W_BUFS * 128 * 128
                + 16 * (depth + 2 * MAC_W_BUFS))
        assert smem_bytes("dcim_mac", cfg) == want <= SMEM_BUDGET_BYTES
        # the K split's partial tile (256 x 128 int32) fits in the rings
        assert depth * 256 * 128 + 2 * MAC_W_BUFS * 128 * 128 >= 256 * 128 * 4

    @pytest.mark.parametrize("tc", [
        TileConfig(bm=256, bn=128, bk=128, depth=1),
        TileConfig(bm=256, bn=128, bk=128, depth=5),
        TileConfig(bm=128, bn=128, bk=128, depth=4),
        TileConfig(bm=256, bn=256, bk=128, depth=4),
        TileConfig(bm=256, bn=128, bk=64, depth=4),
        TileConfig(bm=64, bn=64, bk=128, depth=2)])
    def test_dcim_mac_outside_the_compiled_block(self, tc):
        assert not feasible("dcim_mac", tc)
        with pytest.raises(ValueError, match="Hopper"):
            resolve_tile("dcim_mac", tc)

    def test_unknown_kernel_raises(self):
        with pytest.raises(ValueError, match="unknown kernel"):
            tile_space("nope", (8, 8))

    @pytest.mark.parametrize("tc", [
        TileConfig(bm=64, bn=256, bk=128, depth=4), TileConfig(bt=32, bd=64),
        TileConfig(bh=128, bn=64, depth=1), TileConfig()])
    def test_tile_config_round_trip(self, tc):
        assert TileConfig.from_dict(tc.as_dict()) == tc
        # a JAX package payload reads as the same posture
        jtc = jax_tiles.TileConfig(**tc.__dict__)
        assert TileConfig.from_dict(jtc.as_dict()) == tc
        assert jax_tiles.TileConfig.from_dict(tc.as_dict()) == jtc

    def test_resolve_fills_from_default_and_checks(self):
        assert resolve_tile("ssm_scan", TileConfig(bt=64)) == \
            TileConfig(bt=64, bd=128, depth=2)
        assert resolve_tile("csa_tree", None) == DEFAULT_TILES["csa_tree"]
        with pytest.raises(ValueError, match="Hopper"):
            resolve_tile("csa_tree", TileConfig(bh=512, bn=256))
        with pytest.raises(ValueError, match="registers"):
            resolve_tile("csa_tree", TileConfig(bh=CSA_REG_ROWS + 1, bn=128))
        with pytest.raises(TypeError, match="TileConfig"):
            resolve_tile("csa_tree", {"bh": 32})

    def test_defaults_cover_every_kernel(self):
        assert set(KERNELS) == set(jax_tiles.KERNELS)
        assert all(feasible(k, DEFAULT_TILES[k]) for k in KERNELS)


class TestAutotune:
    def test_schema_equals_jax(self):
        assert TILE_SCHEMA == JAX_TILE_SCHEMA == "syndcim-kernel-tile/v1"

    def test_key_by_shape_class_and_backend(self, monkeypatch):
        k1 = tile_key("ssm_scan", (1000, 256), device="cpu")
        assert tile_key("ssm_scan", (1024, 200), device="cpu") == k1
        assert tile_key("ssm_scan", (1025, 256), device="cpu") != k1
        monkeypatch.setattr(torch, "__version__", "999.0.0")
        assert tile_key("ssm_scan", (1000, 256), device="cpu") != k1

    @pytest.mark.parametrize("kernel,shape", [("dcim_mac", (48, 128, 128)),
                                              ("ssm_scan", (96, 128)),
                                              ("csa_tree", (48, 256))])
    def test_publish_fetch_registry_source(self, kernel, shape):
        reg = FakeRegistry()
        res = autotune.autotune(kernel, shape, iters=1, device="cpu",
                                registry=reg)
        assert res.candidates and all(c.ok and c.max_err == 0.0
                                      for c in res.candidates)
        assert len(res.candidates) == len(tile_space(kernel, shape))
        assert res.frontier and res.winner in tile_space(kernel, shape)
        assert reg.store[res.key] == (TILE_SCHEMA, res.payload())
        assert res.payload()["tile"] == res.winner.as_dict()
        assert res.payload()["backend"] == autotune.backend_digest("cpu")
        # memo first, then (a fresh process) the registry, then the memo
        assert autotune.lookup_with_source(kernel, shape, device="cpu") == \
            (res.winner, "memo")
        autotune.clear_memo()
        assert autotune.lookup_with_source(kernel, shape, registry=reg,
                                           device="cpu") == \
            (res.winner, "registry")
        assert autotune.lookup_with_source(kernel, shape, device="cpu") == \
            (res.winner, "memo")

    def test_cold_lookup_is_the_default(self):
        reg = FakeRegistry()
        assert autotune.lookup_with_source("csa_tree", (10_000, 256),
                                           registry=reg, device="cpu") == \
            (DEFAULT_TILES["csa_tree"], "default")
        assert reg.fetches == 1

    def test_auto_dispatch_reads_the_installed_registry(self):
        reg = FakeRegistry()
        res = autotune.autotune("csa_tree", (48, 256), iters=1,
                                device="cpu", registry=reg, memoize=False)
        autotune.set_registry(reg)
        x = torch.as_tensor(np.arange(48 * 256, dtype=np.int32)
                            .reshape(48, 256))
        c = get_registry().counter
        before = {s: c(f"kernel/csa_tree/tile_source/{s}").value
                  for s in ("registry", "memo")}
        csa_tree_sum(x, tile_config="auto")
        csa_tree_sum(x, tile_config="auto")
        assert c("kernel/csa_tree/tile_source/registry").value == \
            before["registry"] + 1
        assert c("kernel/csa_tree/tile_source/memo").value == \
            before["memo"] + 1
        assert reg.fetches == 1
        assert autotune.lookup("csa_tree", (48, 256), device="cpu") == \
            res.winner


def _kernel_counters(reg):
    return {k: v for k, v in reg.as_dict().items() if k.startswith("kernel/")}


def _delta(reg, fn):
    before = _kernel_counters(reg)
    fn()
    after = _kernel_counters(reg)
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


class TestDispatchCounters:
    """The same calls record the same counter names in both packages (the
    JAX package's Pallas path, in interpret mode)."""

    @staticmethod
    def calls():
        rng = np.random.default_rng(4)
        x = rng.integers(-99, 99, (600, 256), dtype=np.int32)
        x_short = x[:64]
        a = rng.uniform(0.7, 1.0, (40, 128)).astype(np.float32)
        b = rng.normal(size=(40, 128)).astype(np.float32)
        h0 = np.zeros(128, np.float32)
        # 64 tokens, aligned rows: the port's TMA route, "pipelined" as the
        # JAX package's default depth-2 call
        qa = rng.integers(-8, 8, (64, 128), dtype=np.int8)
        qw = rng.integers(-8, 8, (128, 64), dtype=np.int8)
        j, t = jnp.asarray, torch.as_tensor
        jtc, ttc = jax_tiles.TileConfig, TileConfig
        kw = dict(use_pallas=True, interpret=True)
        return {
            "csa_rows": (lambda: jax_csa_tree_sum(j(x_short), **kw),
                         lambda: csa_tree_sum(t(x_short))),
            "csa_tall": (lambda: jax_csa_tree_sum(j(x), **kw),
                         lambda: csa_tree_sum(t(x))),
            "csa_explicit": (
                lambda: jax_csa_tree_sum(j(x_short), tile_config=jtc(
                    bh=32, bn=128), **kw),
                lambda: csa_tree_sum(t(x_short), tile_config=ttc(
                    bh=32, bn=128))),
            "ssm_default": (lambda: jax_ssm_scan(j(a), j(b), j(h0), **kw),
                            lambda: ssm_scan(t(a), t(b), t(h0))),
            "ssm_grid": (
                lambda: jax_ssm_scan(j(a), j(b), j(h0), tile_config=jtc(
                    bt=32, bd=128, depth=1), **kw),
                lambda: ssm_scan(t(a), t(b), t(h0), tile_config=ttc(
                    bt=32, bd=128, depth=1))),
            "ssm_auto": (
                lambda: jax_ssm_scan(j(a), j(b), j(h0), tile_config="auto",
                                     **kw),
                lambda: ssm_scan(t(a), t(b), t(h0), tile_config="auto")),
            "dcim_default": (lambda: jax_dcim_matmul_int(j(qa), j(qw), **kw),
                             lambda: dcim_matmul_int(t(qa), t(qw))),
        }

    @pytest.mark.parametrize("call", ["csa_rows", "csa_tall", "csa_explicit",
                                      "ssm_default", "ssm_grid", "ssm_auto",
                                      "dcim_default"])
    def test_same_counter_names(self, call):
        jax_call, port_call = self.calls()[call]
        want = _delta(jax_get_registry(), jax_call)
        got = _delta(get_registry(), port_call)
        assert got == want and len(got) == 3


class TestDispatchSpan:
    def test_span_tags(self):
        tracer.configure(enabled=True, sample=1.0)
        tracer.clear()
        try:
            x = torch.zeros((8, 64), dtype=torch.int32)
            with tracer.start_trace("request"):
                csa_tree_sum(x, tile_config=TileConfig(bh=32, bn=64))
            spans = [s for s in tracer.drain() if s.name == "kernel.csa_tree"]
        finally:
            tracer.configure(enabled=False)
            tracer.clear()
        (span,) = spans
        assert span.tags["shape"] == "8x64"
        assert span.tags["route"] == "tiled"
        assert span.tags["tile_source"] == "explicit"
        assert span.tags["device"] == "cpu"
        assert span.tags["tile"] == {"bn": 64, "bh": 32, "depth": 2}

    @pytest.mark.parametrize("h,tile_config,kernel", [
        (64, None, "rows"), (300, None, "rows_tall"), (600, None, "tiled"),
        (8, TileConfig(bh=32, bn=64), "tiled")])
    def test_csa_tree_span_names_its_kernel(self, h, tile_config, kernel):
        tracer.configure(enabled=True, sample=1.0)
        tracer.clear()
        try:
            x = torch.zeros((h, 40), dtype=torch.int32)
            with tracer.start_trace("request"):
                csa_tree_sum(x, tile_config=tile_config)
            spans = [s for s in tracer.drain() if s.name == "kernel.csa_tree"]
        finally:
            tracer.configure(enabled=False)
            tracer.clear()
        (span,) = spans
        assert span.tags["kernel"] == kernel

    def test_untraced_calls_open_no_span(self):
        tracer.clear()
        csa_tree_sum(torch.zeros((4, 32), dtype=torch.int32))
        assert tracer.drain() == []


def test_obs_copy_has_the_reference_names():
    import repro.obs as jobs
    import repro_torch.obs as tobs
    assert tobs.__all__ == jobs.__all__
    assert tobs.get_registry() is not jobs.get_registry()
